"""``ops.lstm_train_roofline`` in the cells whose end-to-end metric is the learner's
time, ``learner_update_ms``: the same reader, moving that metric."""
from registry import sibling

_BASE = sibling(__file__, "ops.lstm_train_roofline")
UNIT, LAYER, SOURCE, read = _BASE.UNIT, _BASE.LAYER, _BASE.SOURCE, _BASE.read
MOVES = "learner_update_ms"
