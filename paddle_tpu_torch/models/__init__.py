"""Model zoo of the port (counterpart: `paddle_tpu/models/`): BERT-base
pretraining (`bert.py`). The others are not ported yet."""
from . import bert  # noqa: F401
