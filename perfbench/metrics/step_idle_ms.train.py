"""step_idle_ms.train: the median over the traced steps of the device's
idle milliseconds a step (`perfbench.trace.idle_gaps`, gaps under 5 us
included) whose gaps' middles fall inside the step's aligned `train.step`
span; the medians by the part the host was in go to standard error
(`perfbench/spans.py`)."""

import json
import sys

from perfbench import spans


def read(run):
    per = spans.idle_by_step(run)
    if not per:
        return None
    split = {k: spans.median([p[k] for p in per]) for k in per[0]}
    print(f"perfbench spans: idle ms a step by part (medians) {json.dumps(split)}",
          file=sys.stderr)
    return spans.median([spans.step_idle(p) for p in per])
