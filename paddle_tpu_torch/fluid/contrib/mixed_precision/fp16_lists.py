"""AMP op lists (counterpart:
`paddle_tpu/fluid/contrib/mixed_precision/fp16_lists.py`): which ops run
in the 16-bit compute dtype, which in float32, and which follow their
inputs. The same lists serve bfloat16 and float16. The fp8 subset of the
reference is not ported (ROADMAP Queue 1 #10)."""
from __future__ import annotations

# product-bound ops: run in the 16-bit compute dtype
white_list = {
    "conv2d", "depthwise_conv2d", "conv2d_transpose", "matmul", "matmul_v2",
    "mul",
    # accumulates in float32 inside, so bf16 inputs are safe despite the
    # loss epilogue
    "fused_linear_softmax_xent",
}

# numerically sensitive: force float32
black_list = {
    "softmax_with_cross_entropy", "cross_entropy", "exp", "log",
    "mean", "sum", "reduce_mean", "reduce_sum", "softmax",
    "sigmoid_cross_entropy_with_logits", "layer_norm", "batch_norm",
}

# neutral: follow inputs
gray_list = {
    "elementwise_add", "elementwise_mul", "elementwise_sub",
    "elementwise_div", "relu", "gelu", "tanh", "sigmoid", "dropout",
    "pool2d", "transpose2", "reshape2", "concat", "split", "slice",
    "scale",
}


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.gray_list = set(gray_list)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
            self.black_list -= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)
        self.black_varnames = set(custom_black_varnames or [])
