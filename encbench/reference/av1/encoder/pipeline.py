"""The four helpers the decoder reads from the encoder pipeline, copied
from rav1e_tpu_torch/encoder/pipeline.py."""

from __future__ import annotations

from encbench.reference.av1.config import ChromaSampling
from encbench.reference.av1.context.writer import MAX_TXSIZE_RECT
from encbench.reference.av1.partition import BlockSize, PredictionMode
from encbench.reference.av1.tx import TxSize

MIB_SIZE = 16  # 64x64 superblock in mi units


def has_chroma(mi_x: int, mi_y: int, bsize: BlockSize, xdec: int, ydec: int, cs) -> bool:
    """transform_unit.rs:107-121."""
    if cs == ChromaSampling.Cs400:
        return False
    bw, bh = bsize.width_mi, bsize.height_mi
    return ((mi_x & 1) == 1 or (bw & 1) == 0 or xdec == 0) and (
        (mi_y & 1) == 1 or (bh & 1) == 0 or ydec == 0
    )



def build_ief_params(blocks, x: int, y: int, plane: int, xdec: int, ydec: int):
    """Intra edge filter parameters from neighbor block modes
    (reference predict.rs:543-575, tile_state.rs:229-264)."""
    from encbench.reference.av1.ops.intra import IefParams

    bo_x, bo_y = x, y
    if bo_x & 1 == 0:
        bo_x += xdec
    if bo_y & 1 == 1:
        bo_y -= ydec
    above_mode = None
    if bo_y > 0:
        m = blocks.mode if plane == 0 else blocks.uv_mode
        above_mode = PredictionMode(int(m[bo_y - 1, bo_x]))
    bo_x, bo_y = x, y
    if bo_x & 1 == 1:
        bo_x -= xdec
    if bo_y & 1 == 0:
        bo_y += ydec
    left_mode = None
    if bo_x > 0:
        m = blocks.mode if plane == 0 else blocks.uv_mode
        left_mode = PredictionMode(int(m[min(bo_y, blocks.rows - 1), bo_x - 1]))
    return IefParams(above_mode=above_mode, left_mode=left_mode)


def largest_chroma_tx_size(bsize: BlockSize, xdec: int, ydec: int) -> TxSize:
    """Chroma tx covering the whole (subsampled) block, capped at 32x32."""
    plane_bsize = bsize.chroma_block_size(xdec, ydec)
    t = MAX_TXSIZE_RECT[int(plane_bsize)]
    # chroma tx is capped at 32x32
    while t.width > 32 or t.height > 32:
        from encbench.reference.av1.context.writer import SUB_TX_SIZE_MAP

        t = SUB_TX_SIZE_MAP[int(t)]
    return t
