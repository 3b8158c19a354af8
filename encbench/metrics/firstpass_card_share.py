"""Share (%) of the window's scene detections and lookahead groups whose
work ran on the card: the program's ``scene_detect`` and ``lookahead`` spans
lying wholly in the window that hold a ``firstpass_card`` counter (a
zero-length span the program opens in each one that ran the first pass's
kernels), over all of them. None untraced, or when the program opens no
``firstpass_card`` span (a program without the first pass on the card)."""

import bisect

OF = ("scene_detect", "lookahead")


def read(obs):
    if obs.spans is None:
        return None
    marks = sorted(a for n, a, _b in obs.spans if n == "firstpass_card")
    if not marks:
        return None
    spans = [(a, b) for n, a, b in obs.spans
             if n in OF and a >= obs.t0 and b <= obs.t1]
    if not spans:
        return None
    on = 0
    for a, b in spans:
        i = bisect.bisect_left(marks, a)
        on += i < len(marks) and marks[i] <= b
    return 100.0 * on / len(spans)
