"""The reader of the first pass's share on the card, on made-up
observations: counters inside the window's scene detections and lookahead
groups, spans across the window's edges, and a program without the
counter."""

from encbench import harness
from encbench.harness import Observations


def obs(spans):
    o = Observations(t0=10.0, t1=14.0, window_s=4.0, frames=4)
    o.spans = spans
    return o


def read(o):
    return harness.reader("firstpass_card_share")(o)


def test_share_of_spans_holding_a_counter():
    o = obs([
        # across the window's start: not counted, its counter neither
        ("scene_detect", 9.8, 10.1), ("firstpass_card", 10.05, 10.05),
        # three scene detections and a lookahead group inside, one of the
        # detections without its counter (the host ran it)
        ("scene_detect", 10.5, 10.6), ("firstpass_card", 10.6, 10.6),
        ("scene_detect", 11.0, 11.1),
        ("plan", 11.5, 12.5), ("lookahead", 11.6, 12.4),
        ("firstpass_card", 12.3, 12.3),
        ("scene_detect", 13.0, 13.2), ("firstpass_card", 13.1, 13.1),
        # across the window's end
        ("lookahead", 13.9, 14.2), ("firstpass_card", 13.95, 13.95),
    ])
    assert read(o) == 75.0


def test_none_without_the_counter_or_untraced():
    assert read(obs([("scene_detect", 10.5, 10.6),
                     ("lookahead", 11.0, 11.2)])) is None
    assert read(Observations(t0=10.0, t1=14.0, window_s=4.0,
                             frames=4)) is None
