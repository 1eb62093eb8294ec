"""The control: a run that computes in the precision below the one the
configuration states, which the check has to find not correct.

The vector arm serves bf16 rows and a bf16 query with f32 sums; the step
below is int8. The program has such a lane of its own (``scan_mode
"int8"``: K4 and K2's int8 form on the card), so the control is the
program with that lane switched on through the configuration.
``benchmark/calibrate.py`` runs it on the card; benchmark/tests keep it at
a size a test run holds.
"""

from __future__ import annotations

import copy


def int8_lane(cfg: dict) -> dict:
    out = copy.deepcopy(cfg)
    out["searcher"]["scan_mode"] = "int8"
    return out
