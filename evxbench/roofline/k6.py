"""K6 wave_pass (gpu/csrc/wave.cu `wave_kernel`): the conformance
encoder's wavefront, one persistent launch a frame. Counts from its
arguments' shapes, as the port's kernel table counts them: per macroblock
the int32 source and prediction blocks, its self-SAD, K5's nine int32
fields, eleven int32 fields and the int16 coefficient block out; the
current ring slot read (int16) and the reconstruction written (int32).
Per macroblock 61 intra candidates of 384 absolute differences and four
8-term passes over 384 coefficients."""

KERNEL = "wave_kernel"


def work(width: int, height: int) -> tuple[int, int]:
    """(bytes, integer operations) of one launch on a frame of this size."""
    aw, ah = -(-width // 16) * 16, -(-height // 16) * 16
    n = (aw // 16) * (ah // 16)
    nbytes = n * (384 * 4 * 2 + 4 + 9 * 4 + 11 * 4 + 384 * 2) \
        + ah * aw * 3 // 2 * (2 + 4)
    return nbytes, n * (61 * 384 + 4 * 384 * 8)
