"""rav1e_tpu_torch.device.graphs.AnalysisPrograms and CdefPrograms on the
CPU, the port alone.

On a card the runners replay one CUDA graph per key; on the CPU they run
the same calls eagerly into the same static buffers and copy out the same
outputs, so these tests see what a replay would leave behind: the analysis
runner equals ``analysis._frame_analysis`` at each of its four keys with q
and lambda changing between frames, results already handed out survive
later dispatches of the key, the CDEF runner equals ``cdef_stage_core`` on
fresh tensors at two strength-list keys, and after a key's first frame
neither body reads a device value on the host nor makes a tensor from host
data, which a capture could not do.  The card runs the graphs in
chip_smoke.py's analysis, slice and chain-off phases."""

import numpy as np
import pytest
import torch
from host_reads import HostReads
from torch_threads import one_torch_cpu_thread  # noqa: F401

from rav1e_tpu_torch import tables
from rav1e_tpu_torch.device import analysis, kernels
from rav1e_tpu_torch.device.filters import _strength_lists, cdef_stage_core
from rav1e_tpu_torch.device.graphs import AnalysisPrograms, CdefPrograms

W, H = 128, 128
# (has_inter, has_bwd, has_bwd2) of the four keys of a pyramid clip
KEYS = {"intra": (False, False, False), "fwd": (True, False, False),
        "fwd+bwd": (True, True, False), "fwd+bwd+bwd2": (True, True, True)}


def _planes(seed, n=4):
    """n seeded 8-bit luma planes of one moving texture, (H, W) uint8."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (H // 4 + 8, W // 4 + 8))
    tex = np.repeat(np.repeat(coarse, 4, 0), 4, 1).astype(np.int32)
    return [np.clip(tex[2 * i : 2 * i + H, 3 * i : 3 * i + W]
                    + rng.integers(-5, 6, (H, W)), 0, 255).astype(np.uint8)
            for i in range(n)]


def _lam(qi):
    return 0.12 * (tables.ac_q(qi, 0, 8) / 8.0) ** 2


def _dispatch(programs, planes, flags, qi):
    refs = [p if used else None for p, used in zip(planes[1:], flags)]
    return analysis.analyze_frame_async(
        planes[0], refs[0], refs[1], qi, _lam(qi), 8, ref2_np=refs[2],
        device="cpu", programs=programs)


def _eager(planes, flags, qi):
    """The seven outputs of _frame_analysis on fresh tensors."""
    t = [torch.from_numpy(p).to(torch.int32) for p in planes]
    ref0 = t[1] if flags[0] else t[0]
    ref1 = t[2] if flags[1] else ref0
    ref2 = t[3] if flags[2] else ref0
    q, lam = analysis._scalars(qi, _lam(qi), 8, "cpu")
    return analysis._frame_analysis(t[0], ref0, ref1, ref2, q, lam, 8,
                                    *flags)[:7]


def _assert_equal(got, want):
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("key", list(KEYS))
def test_analysis_runner_equals_frame_analysis(key):
    """Two frames of one key at two quantizers: the first makes the static
    outputs, the second overwrites them; each equals _frame_analysis on its
    own inputs."""
    flags = KEYS[key]
    programs = AnalysisPrograms("cpu")
    for seed, qi in ((1, 100), (2, 160)):
        planes = _planes(seed)
        handle = _dispatch(programs, planes, flags, qi)
        assert handle[1:] == flags
        _assert_equal(handle[0], _eager(planes, flags, qi))
    assert programs.stats() == {
        "keys": 1, "captured": 0, "eager": 2, "captures": 0, "replays": 0,
        "pool_bytes": 0,
        "by_key": [((H, W), 8, *flags, 2, 0)]}


def test_dispatches_keep_their_maps():
    """Three dispatches of one key before any analyze_finish, as the
    pipeline's predispatch makes them: each finishes to its own maps."""
    flags = KEYS["fwd+bwd"]
    programs = AnalysisPrograms("cpu")
    frames = [(_planes(seed), qi) for seed, qi in ((3, 90), (4, 120),
                                                   (5, 150))]
    handles = [_dispatch(programs, p, flags, qi) for p, qi in frames]
    for handle, (planes, qi) in zip(handles, frames):
        got = analysis.analyze_finish(handle)
        want = analysis.analyze_finish((_eager(planes, flags, qi), *flags))
        for field in ("size_log2", "mode", "use_inter", "mv0", "mv1"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        assert got.bits_est == want.bits_est
        assert got.mv2 is None
    assert programs.stats()["eager"] == 3


def test_pack_outputs_round_trip():
    out = _eager(_planes(6), KEYS["fwd+bwd+bwd2"], 120)
    _assert_equal(analysis.unpack_outputs(analysis.pack_outputs(out),
                                          (H, W)), out)
    with pytest.raises(ValueError, match="analysis output"):
        analysis.pack_outputs(out[:2] + (out[2].to(torch.int32),) + out[3:])


@pytest.mark.parametrize("key", ["intra", "fwd+bwd+bwd2"])
def test_analysis_is_capturable_after_the_first_frame(key):
    flags = KEYS[key]
    programs = AnalysisPrograms("cpu")
    _dispatch(programs, _planes(7), flags, 120)  # the key's eager frame
    d = programs._keys[((H, W), 8, *flags)].data
    with HostReads() as mode:
        analysis.analysis_call(d, 8, flags)
    assert mode.found == []


def test_launches_inside_a_capture_count_at_each_replay():
    """A wrapper's launch inside a capture goes to the capture's tally, not
    to LAUNCHES; each replay adds the tally (graphs.Graph.replay)."""
    kernels.reset_launches()
    with kernels.counting_capture() as tally:
        kernels._count("satd8")
        kernels._count("grid_search")
        kernels._count("satd8")
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    assert tally == {**zero, "satd8": 2, "grid_search": 1}
    assert kernels.LAUNCHES == zero
    kernels._count("satd8")
    for _ in range(3):
        kernels.add_launches(tally)
    assert kernels.LAUNCHES == {**zero, "satd8": 7, "grid_search": 3}
    kernels.reset_launches()


# the CDEF stage at 4:2:0 on a 96x80 frame: (nby, nbx) cells of 8x8 luma
NBY, NBX = 10, 12
CDEF_PLANES = ((8, 8, 80, 96), (4, 4, 40, 48), (4, 4, 40, 48))
CDEF_GRID = (NBY, NBX, 2, 2, 96, 80)


def _cdef_inputs(seed):
    rng = np.random.default_rng(seed)
    rec = [rng.integers(0, 256, (NBY * ys + 4, NBX * xs + 4)).astype(np.uint8)
           for ys, xs, _, _ in CDEF_PLANES]
    src = [np.clip(r[2:-2, 2:-2].astype(np.int32)
                   + rng.integers(-8, 9, (r.shape[0] - 4, r.shape[1] - 4)),
                   0, 255).astype(np.uint8) for r in rec]
    return rec, src, rng.random((NBY, NBX)) < 0.7


def test_cdef_runner_equals_stage_core():
    """Frames at two strength-list keys, in turns: each run equals
    cdef_stage_core on fresh tensors, and each key is run eagerly on the
    CPU into its own static buffers."""
    lists = [_strength_lists(9, 5), _strength_lists(21, 9)]
    programs = CdefPrograms("cpu")
    for seed, (y, uv) in zip((1, 2, 3, 4), lists * 2):
        rec, src, filt = _cdef_inputs(seed)
        outs, idx = programs.run(CDEF_PLANES, CDEF_GRID, 5, 8, rec, src,
                                 filt, y, uv)
        want_outs, want_idx = cdef_stage_core(
            CDEF_PLANES, CDEF_GRID, 5, 8,
            [torch.from_numpy(r) for r in rec],
            [torch.from_numpy(s) for s in src], torch.from_numpy(filt), y,
            uv)
        assert torch.equal(idx, want_idx)
        for a, b in zip(outs, want_outs):
            assert torch.equal(a, b)
    st = programs.stats()
    assert (st["keys"], st["eager"], st["replays"]) == (2, 4, 0)


def test_cdef_stage_is_capturable_after_the_first_frame():
    y, uv = _strength_lists(21, 9)
    programs = CdefPrograms("cpu")
    rec, src, filt = _cdef_inputs(5)
    programs.run(CDEF_PLANES, CDEF_GRID, 5, 8, rec, src, filt, y, uv)
    key = (CDEF_PLANES, CDEF_GRID, 5, 8, tuple(y), tuple(uv))
    d = programs._keys[key].data
    with HostReads() as mode:
        cdef_stage_core(CDEF_PLANES, CDEF_GRID, 5, 8, d["rec"], d["src"],
                        d["filt"], y, uv)
    assert mode.found == []
