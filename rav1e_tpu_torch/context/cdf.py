"""CDF context: every adaptive symbol distribution for one tile.

Counterpart of the reference's ``src/context/cdf_context.rs``: the same CDF
set, initialized from the normative defaults (qindex-binned for the
coefficient CDFs), with an undo log so RDO can rewind entropy state.

Layout: each field is a numpy uint16 array whose last axis is one CDF
(inverted Q15; final element doubles as the adaptation counter).  The undo
log stores (array, flat_row_index, row_copy) triples.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from rav1e_tpu_torch import tables
from rav1e_tpu_torch.ec import update_cdf

# fields initialized from extracted default tables:
# our_name -> (archive, table_name, qindex_binned)
_FIELDS = {
    "partition_w8_cdf": ("mode", "default_partition_w8_cdf"),
    "partition_cdf": ("mode", "default_partition_cdf"),
    "partition_w128_cdf": ("mode", "default_partition_w128_cdf"),
    "kf_y_cdf": ("mode", "default_kf_y_mode_cdf"),
    "y_mode_cdf": ("mode", "default_if_y_mode_cdf"),
    "uv_mode_cdf": ("mode", "default_uv_mode_cdf"),
    "uv_mode_cfl_cdf": ("mode", "default_uv_mode_cfl_cdf"),
    "cfl_sign_cdf": ("mode", "default_cfl_sign_cdf"),
    "cfl_alpha_cdf": ("mode", "default_cfl_alpha_cdf"),
    "newmv_cdf": ("mode", "default_newmv_cdf"),
    "zeromv_cdf": ("mode", "default_zeromv_cdf"),
    "refmv_cdf": ("mode", "default_refmv_cdf"),
    "drl_cdfs": ("mode", "default_drl_cdf"),
    "intra_tx_2_cdf": ("mode", "default_intra_tx_2_cdf"),
    "intra_tx_1_cdf": ("mode", "default_intra_tx_1_cdf"),
    "inter_tx_3_cdf": ("mode", "default_inter_tx_3_cdf"),
    "inter_tx_2_cdf": ("mode", "default_inter_tx_2_cdf"),
    "inter_tx_1_cdf": ("mode", "default_inter_tx_1_cdf"),
    "tx_size_8x8_cdf": ("mode", "default_tx_size_8x8_cdf"),
    "tx_size_cdf": ("mode", "default_tx_size_cdf"),
    "txfm_partition_cdf": ("mode", "default_txfm_partition_cdf"),
    "skip_cdfs": ("mode", "default_skip_cdfs"),
    "intra_inter_cdfs": ("mode", "default_intra_inter_cdf"),
    "angle_delta_cdf": ("mode", "default_angle_delta_cdf"),
    "filter_intra_cdfs": ("mode", "default_filter_intra_cdfs"),
    "filter_intra_mode_cdf": ("mode", "default_filter_intra_mode_cdf"),
    "palette_y_mode_cdfs": ("mode", "default_palette_y_mode_cdfs"),
    "palette_uv_mode_cdfs": ("mode", "default_palette_uv_mode_cdfs"),
    "palette_y_size_cdf": ("mode", "default_palette_y_size_cdf"),
    "palette_uv_size_cdf": ("mode", "default_palette_uv_size_cdf"),
    "comp_mode_cdf": ("mode", "default_comp_mode_cdf"),
    "comp_ref_type_cdf": ("mode", "default_comp_ref_type_cdf"),
    "comp_ref_cdf": ("mode", "default_comp_ref_cdf"),
    "comp_bwd_ref_cdf": ("mode", "default_comp_bwdref_cdf"),
    "single_ref_cdfs": ("mode", "default_single_ref_cdf"),
    "compound_mode_cdf": ("mode", "default_compound_mode_cdf"),
    "deblock_delta_multi_cdf": ("mode", "default_delta_lf_multi_cdf"),
    "deblock_delta_cdf": ("mode", "default_delta_lf_cdf"),
    "spatial_segmentation_cdfs": ("mode", "default_spatial_pred_seg_tree_cdf"),
    "lrf_switchable_cdf": ("mode", "default_switchable_restore_cdf"),
    "lrf_sgrproj_cdf": ("mode", "default_sgrproj_restore_cdf"),
    "lrf_wiener_cdf": ("mode", "default_wiener_restore_cdf"),
    "skip_mode_cdfs": ("mode", "default_skip_mode_cdfs"),
    "intrabc_cdf": ("mode", "default_intrabc_cdf"),
    # NMV (motion vector) context — one per frame + duplicated per component
    "nmv_joints_cdf": ("mode", "nmv_joints_cdf"),
    # coefficient CDFs (qindex-binned)
    "txb_skip_cdf": ("token", "av1_default_txb_skip_cdfs"),
    "dc_sign_cdf": ("token", "av1_default_dc_sign_cdfs"),
    "eob_extra_cdf": ("token", "av1_default_eob_extra_cdfs"),
    "eob_flag_cdf16": ("token", "av1_default_eob_multi16_cdfs"),
    "eob_flag_cdf32": ("token", "av1_default_eob_multi32_cdfs"),
    "eob_flag_cdf64": ("token", "av1_default_eob_multi64_cdfs"),
    "eob_flag_cdf128": ("token", "av1_default_eob_multi128_cdfs"),
    "eob_flag_cdf256": ("token", "av1_default_eob_multi256_cdfs"),
    "eob_flag_cdf512": ("token", "av1_default_eob_multi512_cdfs"),
    "eob_flag_cdf1024": ("token", "av1_default_eob_multi1024_cdfs"),
    "coeff_base_eob_cdf": ("token", "av1_default_coeff_base_eob_multi_cdfs"),
    "coeff_base_cdf": ("token", "av1_default_coeff_base_multi_cdfs"),
    "coeff_br_cdf": ("token", "av1_default_coeff_lps_multi_cdfs"),
}

_NMV_COMP_FIELDS = [
    "nmv_sign_cdf",
    "nmv_class0_hp_cdf",
    "nmv_hp_cdf",
    "nmv_class0_cdf",
    "nmv_bits_cdf",
    "nmv_class0_fp_cdf",
    "nmv_fp_cdf",
    "nmv_classes_cdf",
]


class CDFContext:
    """All adaptive CDFs for one tile's symbol stream."""

    def __init__(self, qindex: int):
        if qindex <= 20:
            qctx = 0
        elif qindex <= 60:
            qctx = 1
        elif qindex <= 120:
            qctx = 2
        else:
            qctx = 3
        for name, (kind, table) in _FIELDS.items():
            if kind == "mode":
                arr = tables.default_cdf(table).copy()
            else:
                arr = tables.token_cdf(table)[qctx].copy()
            setattr(self, name, arr)
        # per-component MV CDFs (comps[0] == comps[1] at init)
        for f in _NMV_COMP_FIELDS:
            base = tables.default_cdf(f)
            setattr(self, f, np.stack([base.copy(), base.copy()]))

    def copy(self) -> "CDFContext":
        c = CDFContext.__new__(CDFContext)
        for name in list(_FIELDS) + _NMV_COMP_FIELDS:
            setattr(c, name, getattr(self, name).copy())
        return c

    def reset_counts(self) -> None:
        """Zero the adaptation counters (last element of every CDF row)."""
        for name in list(_FIELDS) + _NMV_COMP_FIELDS:
            arr = getattr(self, name)
            arr.reshape(-1, arr.shape[-1])[:, -1] = 0


class CDFContextLog:
    """Undo log enabling cheap rollback of CDF adaptation during RDO
    (reference: ``CDFContextLog``, cdf_context.rs:647-686)."""

    __slots__ = ("entries",)

    def __init__(self):
        self.entries: List[Tuple[np.ndarray, tuple, np.ndarray]] = []

    def checkpoint(self) -> int:
        return len(self.entries)

    def push(self, arr: np.ndarray, idx: tuple) -> np.ndarray:
        row = arr[idx]
        self.entries.append((arr, idx, row.copy()))
        return row

    def rollback(self, point: int) -> None:
        for arr, idx, saved in reversed(self.entries[point:]):
            arr[idx] = saved
        del self.entries[point:]

    def clear(self) -> None:
        self.entries.clear()
