"""Fleet meta-optimizer composition (counterpart:
`paddle_tpu/fleet/meta_optimizers.py`; reference:
`python/paddle/fleet/meta_optimizers/` and
`fleet/base/strategy_compiler.py`): each DistributedStrategy knob maps to
a wrapper of the user optimizer, applied in a fixed order after the
conflicting knobs are turned off.

Ported: LAMB (the user optimizer swapped for `LambOptimizer`, keeping
Adam's betas and epsilon, the regularization and the clip), LARS (a
Momentum optimizer swapped for `LarsMomentumOptimizer`) and AMP
(`fluid.contrib.mixed_precision.decorate` with `amp_configs`). The
wrappers whose inner optimizers are not ported yet (recompute, gradient
merge, pipeline) raise where they would apply, naming ROADMAP Queue 1
#5.
"""
from __future__ import annotations

import warnings
from typing import List


class MetaOptimizerBase:
    """One strategy knob -> one wrapper (reference:
    meta_optimizers/meta_optimizer_base.py)."""

    name = "base"

    def can_apply(self, strategy, optimizer) -> bool:
        raise NotImplementedError

    def apply(self, strategy, optimizer):
        raise NotImplementedError


class _NotPortedMeta(MetaOptimizerBase):
    """A knob whose wrapper is not ported: raises where it applies."""

    def __init__(self, name, inner, applies):
        self.name = name
        self._inner = inner
        self._applies = applies

    def can_apply(self, strategy, optimizer):
        return bool(self._applies(strategy, optimizer))

    def apply(self, strategy, optimizer):
        raise NotImplementedError(
            "DistributedStrategy.%s needs %s, which is not ported yet "
            "(ROADMAP Queue 1 #5)" % (self.name, self._inner))


class LambMetaOptimizer(MetaOptimizerBase):
    name = "lamb"

    def can_apply(self, strategy, optimizer):
        return strategy.lamb and \
            not type(optimizer).__name__.startswith("Lamb")

    def apply(self, strategy, optimizer):
        from ..fluid.optimizer import AdamOptimizer, LambOptimizer

        kw = {}
        if isinstance(optimizer, AdamOptimizer):
            kw = {"beta1": optimizer._beta1, "beta2": optimizer._beta2,
                  "epsilon": optimizer._epsilon}
        return LambOptimizer(
            learning_rate=optimizer._learning_rate,
            regularization=getattr(optimizer, "regularization", None),
            grad_clip=getattr(optimizer, "_grad_clip", None), **kw)


class LarsMetaOptimizer(MetaOptimizerBase):
    name = "lars"

    def can_apply(self, strategy, optimizer):
        return strategy.lars and \
            type(optimizer).__name__.startswith("Momentum")

    def apply(self, strategy, optimizer):
        from ..fluid.optimizer import LarsMomentumOptimizer

        return LarsMomentumOptimizer(
            learning_rate=optimizer._learning_rate,
            momentum=getattr(optimizer, "_momentum", 0.9),
            regularization=getattr(optimizer, "regularization", None),
            grad_clip=getattr(optimizer, "_grad_clip", None))


class AMPMetaOptimizer(MetaOptimizerBase):
    name = "amp"

    def can_apply(self, strategy, optimizer):
        return strategy.amp

    def apply(self, strategy, optimizer):
        from ..fluid.contrib import mixed_precision

        return mixed_precision.decorate(optimizer, **strategy.amp_configs)


# application order matters: optimizer swaps first, then recompute /
# gradient_merge wrap, pipeline cuts the program, AMP decorates last so
# the cast policy sees the final graph (reference: strategy_compiler
# ordering)
_META_ORDER: List[MetaOptimizerBase] = [
    LambMetaOptimizer(),
    LarsMetaOptimizer(),
    _NotPortedMeta("recompute", "RecomputeOptimizer", lambda s, o:
                   s.recompute and s.recompute_configs.get("checkpoints")),
    _NotPortedMeta("gradient_merge", "GradientMergeOptimizer",
                   lambda s, o: s.gradient_merge and not s.pipeline),
    _NotPortedMeta("pipeline", "PipelineOptimizer",
                   lambda s, o: s.pipeline),
    AMPMetaOptimizer(),
]

# conflict table (reference: each meta-optimizer's _disable_strategy
# zeroes knobs it cannot coexist with): winner knob -> knobs it
# disables, with the why for the warning
_CONFLICTS = [
    ("pipeline", "sync_batch_norm",
     "the pipeline engine's minimize branch owns the program rewrite; "
     "BN-stat synchronization over dp replicas of a pipeline is not "
     "wired — stats stay per-replica"),
    ("pipeline", "a_sync",
     "pipeline training is collective-mode; the parameter-server "
     "rewrite cannot compose with the stage cut"),
    ("lamb", "lars",
     "lamb replaces the base optimizer; lars (a Momentum wrapper) "
     "cannot also apply"),
    ("localsgd", "dgc",
     "localsgd averages parameters every k steps; dgc's sparse "
     "momentum-corrected grads assume per-step dense allreduce"),
    ("pipeline", "recompute",
     "the GPipe engine owns the per-stage computation; recompute "
     "checkpoints are not segmented across pipeline cuts yet"),
    ("pipeline", "localsgd",
     "pipeline grads psum over the ring every step; k-step parameter "
     "averaging would diverge the stages"),
]


def resolve_conflicts(strategy):
    """StrategyCompiler._disable_strategy pass: mutate the strategy so
    conflicting knobs are turned off LOUDLY; returns disabled names."""
    disabled = []
    for winner, loser, why in _CONFLICTS:
        if getattr(strategy, winner, False) and \
                getattr(strategy, loser, False):
            warnings.warn("DistributedStrategy: %s disabled because %s "
                          "is set (%s)" % (loser, winner, why))
            setattr(strategy, loser, False)
            disabled.append(loser)
    return disabled


def compose(strategy, optimizer):
    """StrategyCompiler: resolve knob conflicts, then fold the
    applicable meta-optimizers over the user optimizer; returns
    (wrapped_optimizer, applied_names)."""
    resolve_conflicts(strategy)
    applied = []
    for meta in _META_ORDER:
        if meta.can_apply(strategy, optimizer):
            optimizer = meta.apply(strategy, optimizer)
            applied.append(meta.name)
    return optimizer, applied
