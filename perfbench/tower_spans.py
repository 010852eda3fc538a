"""The device time of the tube encoder's sub-blocks, from the program's
spans of a traced run: `vid.temporal`, `vid.spatial` and `vid.mlp`, which
TimeSformer's blocks open around their three sub-blocks
(`avtubes_torch/models/timesformer.py`).  A sub-block's time in a step is
the sum over the blocks of its spans' device milliseconds inside that
step's `train.forward` part; the recomputation that `--remat` runs inside
`train.backward` is left out.  A program or a tower that opens no such span
gives nothing to read."""

from __future__ import annotations

from perfbench import spans


def forward_device_ms(run, name: str) -> float | None:
    """The median over the traced steps of the summed device milliseconds
    of the spans `name` inside each step's `train.forward`."""
    steps = spans.steps(run)
    got = spans.recorded()
    if not steps or got is None:
        return None
    recorded = got[0]
    parent = {s.id: s.parent for s in recorded}
    forward = {st.parts["train.forward"].id: i for i, st in enumerate(steps)
               if "train.forward" in st.parts}
    totals: dict[int, float] = {}
    for s in recorded:
        if s.name != name or s.device_ms is None:
            continue
        up = s.parent
        while up is not None and up not in forward:
            up = parent.get(up)
        if up is not None:
            totals[forward[up]] = totals.get(forward[up], 0.0) + s.device_ms
    return spans.median(list(totals.values()))
