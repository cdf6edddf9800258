"""How evenly ``kernel_plan``'s stage split weighs VT's stages: S times the
heaviest stage's weight over the sum of the S weights (1.0 when even, S
when one stage holds all of it), from the ``stage_weights`` attribute of
the program's ``vt.launch`` spans, averaged over the window's launches, in
the cells of ``family``.  A program whose spans lack that attribute gives
nothing to read."""

from cimbench import spans


def read(trace, family):
    got = spans.window(trace, family)
    if got is None:
        return None
    ws = [s.get("attrs", {}).get("stage_weights") for s in got if s["name"] == "vt.launch"]
    ws = [w for w in ws if w]
    if not ws:
        return None
    return sum(len(w) * max(w) / sum(w) for w in ws) / len(ws)
