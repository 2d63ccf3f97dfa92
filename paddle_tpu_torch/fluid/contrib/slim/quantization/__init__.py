"""fluid.contrib.slim.quantization (counterpart:
`paddle_tpu/fluid/contrib/slim/quantization/`): quantization-aware
training passes and post-training quantization."""
from .quantization_pass import (  # noqa: F401
    QuantizationTransformPass, QuantizationFreezePass,
    OutScaleForTrainingPass, OutScaleForInferencePass,
)
from .post_training_quantization import (  # noqa: F401
    PostTrainingQuantization,
)
