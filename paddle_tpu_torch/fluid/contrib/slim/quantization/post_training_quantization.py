"""Post-training quantization (counterpart:
`paddle_tpu/fluid/contrib/slim/quantization/post_training_quantization.py`;
reference: contrib/slim/quantization/post_training_quantization.py):
calibration batches run through the float32 program on the port's
`Executor` (on the card unless it was given the CPU), collecting each
quantizable op's input abs-max; then `QuantizationTransformPass`
rewrites the program and the calibrated scales are bound into its
activation quantizers as `static_scale` attrs.
"""
from __future__ import annotations

import numpy as np

from .quantization_pass import (_INPUT_SLOTS, _QUANTIZABLE,
                                QuantizationTransformPass)


class PostTrainingQuantization:
    def __init__(self, executor, program, feed_list, fetch_list,
                 sample_generator=None, batch_nums=10, scope=None,
                 algo="abs_max", quantizable_op_type=_QUANTIZABLE,
                 weight_bits=8, activation_bits=8):
        self._exe = executor
        self._program = program
        self._feed_list = feed_list
        self._fetch_list = fetch_list
        self._samples = sample_generator
        self._batch_nums = batch_nums
        self._scope = scope
        self._algo = algo
        self._ops = tuple(quantizable_op_type)
        self._wbits = weight_bits
        self._abits = activation_bits
        self.scales = {}

    def quantize(self):
        """Calibrate then rewrite. Returns the quantized program."""
        block = self._program.global_block()
        # tensors to calibrate: activation inputs of quantizable ops
        act_names = []
        for op in block.ops:
            if op.type in self._ops:
                names = op.input_names.get(_INPUT_SLOTS[op.type])
                if names and names[0] not in act_names:
                    act_names.append(names[0])

        for i, feed in enumerate(self._samples() if callable(
                self._samples) else self._samples):
            if i >= self._batch_nums:
                break
            outs = self._exe.run(self._program, feed=feed,
                                 fetch_list=act_names,
                                 scope=self._scope)
            for name, val in zip(act_names, outs):
                cur = float(np.max(np.abs(np.asarray(val))))
                self.scales[name] = max(self.scales.get(name, 0.0), cur)

        # rewrite with static scales: abs_max quant ops see is_test-style
        # fixed scale via a wrapping pass, calibrated scales recorded on
        # the program for save_quantized_model
        pass_ = QuantizationTransformPass(
            weight_bits=self._wbits, activation_bits=self._abits,
            activation_quantize_type="abs_max")
        pass_.apply(self._program)
        # bind the calibrated static scales into the activation quant
        # ops (weights keep dynamic abs-max — they are constants at
        # inference so the two coincide)
        for op in self._program.global_block().ops:
            if op.type == "fake_quantize_abs_max":
                src = op.input_names["X"][0]
                if src in self.scales:
                    op.attrs["static_scale"] = float(self.scales[src])
        self._program._version += 1
        self._program._ptq_scales = dict(self.scales)
        return self._program

    def save_quantized_model(self, save_model_path, model_filename=None,
                             params_filename=None):
        from ....io import save_inference_model

        return save_inference_model(
            save_model_path, list(self._feed_list), self._fetch_list,
            self._exe, main_program=self._program)
