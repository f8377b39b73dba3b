"""Copy of cairo_tpu.checkpoint: the session checkpoint format (.npz of state_dict)."""

from __future__ import annotations

import io
import json

import numpy as np

_META_KEY = "__meta__"


def dump_state(obj) -> bytes:
    """Serializes any object exposing state_dict() -> (meta, arrays)."""
    meta, arrays = obj.state_dict()
    buf = io.BytesIO()
    np.savez(buf, **{_META_KEY: np.frombuffer(
        json.dumps(meta).encode(), np.uint8)}, **arrays)
    return buf.getvalue()


def load_state(obj, data: bytes):
    """Restores state produced by dump_state into obj.load_state_dict()."""
    with np.load(io.BytesIO(data)) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
    obj.load_state_dict(meta, arrays)
    return obj


def save(path: str, obj):
    with open(path, "wb") as f:
        f.write(dump_state(obj))


def load(path: str, obj):
    with open(path, "rb") as f:
        return load_state(obj, f.read())
