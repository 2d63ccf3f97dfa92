"""fluid.unique_name — the public unique-name namespace (counterpart:
`paddle_tpu/fluid/unique_name.py`).

`generate` / `generate_with_ignorable_key` / `switch` / `guard`, over the
same generator state `framework.unique_name` and
`framework.unique_name_guard` use, so the two surfaces compose.
"""
from __future__ import annotations

import contextlib

from . import framework

UniqueNameGenerator = framework._UniqueNameGenerator


def generate(key: str) -> str:
    """Unique name with `key` as prefix, e.g. fc_0, fc_1, ..."""
    return framework.unique_name(key)


def generate_with_ignorable_key(key: str) -> str:
    """Names for intermediate vars the user never addresses; tagged
    `_generated_var_` as in the reference package."""
    return framework.unique_name("_generated_var_" + key)


def switch(new_generator=None):
    """Replace the global generator; returns the previous one."""
    old = framework._name_generator
    framework._name_generator = (new_generator if new_generator
                                 is not None else UniqueNameGenerator())
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    """Fresh (or given) generator within the `with` scope — keeps name
    counters of independently built programs from colliding."""
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
