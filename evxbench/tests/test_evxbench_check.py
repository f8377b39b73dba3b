"""The check that decides `correct`: whole runs of small cells on the CPU
(the harness's look for a card skipped), sound, with the timed path broken
underneath in each way an encode cell can be broken, and with the
control in the program's place; and, on the card, the control at the
cells' own sizes."""

import pytest
import torch

from tiny import run

from cairo_tpu_torch.config import CodecConfig
from cairo_tpu_torch.gpu import api, engine, wavefront
from harness import cell as cell_mod

STEPS = {"fast.closed": (engine, "encode_step"),
         "conformance.closed": (wavefront, "conformance_encode_step")}
RING = ("ring_y", "ring_u", "ring_v")


def failing(result):
    return {k: v["value"] for k, v in result["checks"].items()
            if v["value"] > v["limit"]}


@pytest.mark.parametrize("cell", ["fast.closed", "conformance.closed",
                                  "conformance.open"])
def test_sound_run_is_correct(tmp_path, cell):
    result = run(tmp_path, cell, seconds=3.0)
    assert result["correct"], failing(result)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) >= {"slice_bytes", "recon", "decisions",
                                      "coef_planes", "frames_missing"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", list(STEPS))
def test_step_that_returns_its_state_unchanged(tmp_path, monkeypatch, cell):
    mod, name = STEPS[cell]
    step = getattr(mod, name)

    def stale(src, state, **kw):
        kept = {k: v.clone() for k, v in state.items()}
        _, out = step(src, state, **kw)
        return kept, out
    monkeypatch.setattr(mod, name, stale)
    result = run(tmp_path, cell, seconds=3.0)
    assert not result["correct"]
    assert failing(result).keys() & {"recon", "coef_planes"}


@pytest.mark.parametrize("cell", list(STEPS))
def test_step_that_leaves_out_half_the_macroblocks(tmp_path, monkeypatch,
                                                   cell):
    mod, name = STEPS[cell]
    step = getattr(mod, name)

    def half(src, state, **kw):
        before = {k: state[k].clone() for k in RING}
        new, out = step(src, state, **kw)
        new = dict(new)
        for k in RING:
            h = new[k].shape[1]
            new[k] = new[k].clone()
            new[k][:, h // 2:] = before[k][:, h // 2:]
        return new, out
    monkeypatch.setattr(mod, name, half)
    result = run(tmp_path, cell, seconds=3.0)
    assert not result["correct"]
    assert "recon" in failing(result)


@pytest.mark.parametrize("cell", list(STEPS))
def test_chunk_altered_where_it_is_made(tmp_path, monkeypatch, cell):
    cls = api.ConformanceGpuEncoder if cell.startswith("conformance") \
        else api.GpuEncoder
    finish = cls._finish

    def altered(self, pending):
        chunk = bytearray(finish(self, pending))
        chunk[len(chunk) // 2] ^= 0x10
        return bytes(chunk)
    monkeypatch.setattr(cls, "_finish", altered)
    result = run(tmp_path, cell, seconds=3.0)
    assert not result["correct"]
    assert failing(result).keys() & {"slice_bytes", "descriptor"}


def one_session_faulty(monkeypatch, faulty, fault):
    """Encoders as the cell makes them, the `faulty`-th of them broken
    from its third frame on: its chunks altered where they are made
    ("chunk"), or half of its reconstruction left out ("recon")."""
    make = cell_mod.make_encoder
    made = []

    def make_one(config, device):
        enc = make(config, device)
        if len(made) == faulty and fault == "chunk":
            finish, calls = enc._finish, []

            def altered(pending):
                chunk = bytearray(finish(pending))
                calls.append(1)
                if len(calls) > 2:
                    chunk[len(chunk) // 2] ^= 0x10
                return bytes(chunk)
            enc._finish = altered
        made.append(enc)
        return enc
    monkeypatch.setattr(cell_mod, "make_encoder", make_one)
    if fault == "recon":
        step = wavefront.conformance_encode_step
        calls = []

        def half(src, state, **kw):
            mine = state is made[faulty]._state
            before = {k: state[k].clone() for k in RING}
            new, out = step(src, state, **kw)
            if mine:
                calls.append(1)
            if mine and len(calls) > 2:
                new = dict(new)
                for k in RING:
                    h = new[k].shape[1]
                    new[k] = new[k].clone()
                    new[k][:, h // 2:] = before[k][:, h // 2:]
            return new, out
        monkeypatch.setattr(wavefront, "conformance_encode_step", half)


@pytest.mark.parametrize("seed", [2**31 + 7, 3_000_000_019])
@pytest.mark.parametrize("fault", ["chunk", "recon"])
@pytest.mark.parametrize("faulty", [0, 1, 2])
def test_fault_in_one_session_only(tmp_path, monkeypatch, faulty, fault,
                                   seed):
    """A fault confined to one of the concurrent encoders comes out not
    correct whichever session the check draws for the encoder's work."""
    one_session_faulty(monkeypatch, faulty, fault)
    result = run(tmp_path, "conformance.closed", seed=seed, seconds=3.0,
                 sessions=3)
    assert not result["correct"]
    assert failing(result).keys() & {"slice_bytes", "descriptor", "recon"}


def control_encoder(path):
    """The control: on the conformance path the program's fast encoder in
    its place (it breaks the stated guarantee of the reference encoder's
    own bytes); on the fast path the fast encoder with the in-loop deblock
    off (it breaks the guarantee that any decoder, which deblocks as the
    configuration states, reconstructs the encoder's reference frames)."""
    def make(config, device):
        codec = CodecConfig(**config["codec"])
        if path == "fast":
            codec = CodecConfig(**dict(config["codec"],
                                       enable_deblocking=False))
        enc = api.GpuEncoder(config=codec, device=device)
        enc.set_quality(config["quality"])
        return enc
    return make


@pytest.mark.parametrize("cell,number", [("conformance.closed", "decisions"),
                                         ("fast.closed", "recon")])
def test_control_is_not_correct(tmp_path, monkeypatch, cell, number):
    monkeypatch.setattr(cell_mod, "make_encoder",
                        control_encoder(cell.split(".")[0]))
    result = run(tmp_path, cell, seconds=3.0)
    assert not result["correct"]
    assert number in failing(result)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 11, 2**33 + 5, 3_000_000_019])
@pytest.mark.parametrize("cell", ["conf1080.sessions4", "conf1080.live30"])
def test_control_on_the_card(monkeypatch, cell, seed):
    """The control at the cell's own size and load, a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    path = cell_mod.load_cell(cell)["config"]["path"]
    monkeypatch.setattr(cell_mod, "make_encoder", control_encoder(path))
    result = cell_mod.run_cell(cell, seed, 6.0, False)
    print(cell, seed, {k: v["value"] for k, v in result["checks"].items()})
    assert not result["correct"]
