"""K2 dense_select (gpu/csrc/motion.cu `dense_select_kernel`): the fast
search's full-pel scan of one reference, one launch a reference of each
inter frame. Counts from its arguments' shapes, as the port's kernel
table counts them: the int32 source plane, the int16 reference plane, K1's
int32 chroma maxima (289 a macroblock) read once, 17 bytes a macroblock
written; 1089 candidate offsets of 256 luma samples a macroblock, one
operation each."""

KERNEL = "dense_select_kernel"


def work(width: int, height: int) -> tuple[int, int]:
    """(bytes, integer operations) of one launch on a frame of this size."""
    aw, ah = -(-width // 16) * 16, -(-height // 16) * 16
    n = (aw // 16) * (ah // 16)
    nbytes = ah * aw * 4 + ah * aw * 2 + n * 289 * 4 + n * 17
    return nbytes, n * 1089 * 256
