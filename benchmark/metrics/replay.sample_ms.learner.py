"""``replay.sample_ms`` in the cells whose end-to-end metric is the learner's
time, ``learner_update_ms``: the same reader, moving that metric."""
from registry import sibling

_BASE = sibling(__file__, "replay.sample_ms")
UNIT, LAYER, SOURCE, read = _BASE.UNIT, _BASE.LAYER, _BASE.SOURCE, _BASE.read
MOVES = "learner_update_ms"
