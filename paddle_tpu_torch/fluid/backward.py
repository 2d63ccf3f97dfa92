"""Autodiff: `append_backward(loss)` (counterpart:
`paddle_tpu/fluid/backward.py`).

As in the reference, gradients are a transform, not a program rewrite:
one `backward` pseudo-op records (loss, diff targets), and the lowering
runs the forward segment with `requires_grad` leaves and takes
`torch.autograd.grad` of the loss (`fluid/lowering.py`). The `X@GRAD`
vars still appear in the block (the `@GRAD` naming contract), so
optimizers and fetches address them by name.
"""
from __future__ import annotations

from .framework import Parameter, Variable, grad_var_name


def _collect_forward_used_names(block, upto_idx):
    used = set()
    for op in block.ops[:upto_idx]:
        used.update(op.input_arg_names)
        used.update(op.output_arg_names)
    return used


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append the backward section for `loss`; returns [(param, grad)].
    Recompute `checkpoints` are not ported yet."""
    if not isinstance(loss, Variable):
        raise TypeError("loss must be a Variable, got %r" % (loss,))
    if checkpoints:
        raise NotImplementedError(
            "append_backward(checkpoints=...) (recompute) is not ported "
            "yet")
    block = loss.block
    program = block.program
    no_grad = set()
    if no_grad_set:
        no_grad = {v.name if isinstance(v, Variable) else v
                   for v in no_grad_set}

    upto = len(block.ops)
    used = _collect_forward_used_names(block, upto)

    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in program.global_block().all_parameters()
                  if p.trainable]
    params = [p for p in params if p.name in used and p.name not in no_grad]

    # leaf inputs that ask for a gradient (a feed with stop_gradient off)
    leaf_inputs = []
    for name in used:
        v = block._find_var_recursive(name)
        if (v is not None and not v.stop_gradient and not v.persistable
                and v.op is None and not isinstance(v, Parameter)
                and name not in no_grad):
            leaf_inputs.append(v)

    diff_vars = params + leaf_inputs
    diff_names = [v.name for v in diff_vars]

    params_grads = []
    for v in diff_vars:
        g = block.create_var(
            name=grad_var_name(v.name), shape=v.shape, dtype=v.dtype,
            persistable=False, stop_gradient=True)
        if isinstance(v, Parameter) or v in params:
            params_grads.append((v, g))

    loss_grad = block.create_var(
        name=grad_var_name(loss.name), shape=loss.shape,
        dtype=loss.dtype, stop_gradient=True)

    block.append_op(
        type="backward",
        inputs={"Loss": [loss]},
        outputs={"Grad": [grad_var_name(n) for n in diff_names],
                 "LossGrad": [loss_grad]},
        attrs={"loss_name": loss.name, "diff_names": diff_names,
               "loss_scale": 1.0, "_is_backward": True})
    return params_grads
