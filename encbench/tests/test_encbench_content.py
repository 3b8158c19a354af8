"""The content generator: the same frames for the same seed, other frames
for another seed, and a hard cut every scene_frames frames."""

import json

import numpy as np
import pytest

from encbench.content import Clip
from encbench.tests.conftest import ROOT

TRAFFIC = sorted(p.stem for p in (ROOT / "encbench" / "traffic").glob("*.json"))


def content(name):
    return json.loads((ROOT / "encbench" / "traffic"
                       / f"{name}.json").read_text())["content"]


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_every_mix_cuts_every_48_frames(traffic):
    assert content(traffic)["scene_frames"] == 48


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_deterministic_per_seed(traffic):
    p = dict(content(traffic), scene_frames=6)
    seed = 2**31 + 12345  # above 32 signed bits, as a run's seed may be
    a, b = Clip(p, 96, 64, seed), Clip(p, 96, 64, seed)
    # drawn in another order, the frames are the same
    for i in (7, 0, 13, 6):
        for x, y in zip(a.frame(i), b.frame(i)):
            assert x.dtype == np.uint8 and np.array_equal(x, y)
    other = Clip(p, 96, 64, seed + 1)
    assert not np.array_equal(a.frame(0)[0], other.frame(0)[0])
    assert [x.shape for x in a.frame(0)] == [(64, 96), (32, 48), (32, 48)]


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_cuts(traffic):
    p = dict(content(traffic), scene_frames=6)
    clip = Clip(p, 128, 96, 99)

    def mad(i, j):
        return np.abs(clip.frame(i)[0].astype(int)
                      - clip.frame(j)[0].astype(int)).mean()

    within = max(mad(i, i + 1) for i in range(5))
    assert clip.is_cut(6) and not clip.is_cut(5)
    assert mad(5, 6) > 4 * within


def test_a_library_shows_every_seed_the_same_scenes_in_another_order():
    p = dict(content("vod"), scene_frames=3, library_scenes=4,
             grain_sigma=0.0)
    a, b = Clip(p, 64, 48, 11), Clip(p, 64, 48, 2**31 + 99)
    first = lambda clip, s: clip.scene(s)[0][0]
    assert np.array_equal(first(a, 0), first(b, 0))
    key = lambda clip: sorted(first(clip, s).tobytes() for s in range(4))
    assert key(a) == key(b)
    assert [first(a, s).tobytes() for s in range(4)] != \
        [first(b, s).tobytes() for s in range(4)] or a.order == b.order
    assert np.array_equal(first(a, 4), first(a, 0))


def test_nothing_is_drawn_after_draw_all(monkeypatch):
    """A window of any length finds every frame drawn: the round repeats,
    grain and all, and no frame past it is made anew."""
    from encbench import content as cmod

    p = dict(content("live"), scene_frames=3, library_scenes=3)
    clip = Clip(p, 64, 48, 2**31 + 5)
    clip.draw_all()
    first = [[x.copy() for x in clip.frame(i)] for i in range(9)]

    def no_drawing(*a, **k):
        raise AssertionError("a scene drawn after draw_all")

    monkeypatch.setattr(cmod, "_natural_scene", no_drawing)
    for i in range(9, 10_000, 7):
        for x, y in zip(clip.frame(i), first[i % 9]):
            assert np.array_equal(x, y)
