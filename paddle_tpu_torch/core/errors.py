"""Typed error/enforce system (counterpart: `paddle_tpu/core/errors.py`).

The error taxonomy of the reference's `platform/enforce.h` and
`error_codes.proto`, and the creation-site traceback that
`framework/op_call_stack.cc` attaches to an op's error so that users see
where in their model code the failing op was built.
"""
from __future__ import annotations

import sys


class EnforceNotMet(RuntimeError):
    """Base framework error (reference: enforce.h EnforceNotMet)."""

    code = "LEGACY"


class InvalidArgumentError(EnforceNotMet):
    code = "INVALID_ARGUMENT"


class NotFoundError(EnforceNotMet):
    code = "NOT_FOUND"


class OutOfRangeError(EnforceNotMet):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(EnforceNotMet):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(EnforceNotMet):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(EnforceNotMet):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(EnforceNotMet):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(EnforceNotMet):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(EnforceNotMet):
    code = "UNIMPLEMENTED"


class UnavailableError(EnforceNotMet):
    code = "UNAVAILABLE"


class FatalError(EnforceNotMet):
    code = "FATAL"


class ExternalError(EnforceNotMet):
    code = "EXTERNAL"


# -- op creation-site attribution (reference: op_call_stack.cc) -----------

_FRAMEWORK_MARKERS = ("/paddle_tpu_torch/", "<frozen")


def capture_user_callstack(limit=3):
    """Topmost non-framework frames of the current stack, recorded on
    each Operator at build time and attached to execution errors. Walks
    raw frames with an early stop (no source lookup), so a program build
    pays microseconds per op."""
    frames = []
    f = sys._getframe(2)
    while f is not None and len(frames) < limit:
        fn = f.f_code.co_filename or ""
        if not any(m in fn for m in _FRAMEWORK_MARKERS):
            frames.append("%s:%d in %s" % (fn, f.f_lineno,
                                           f.f_code.co_name))
        f = f.f_back
    return frames


def attach_op_callstack(exc, op):
    """Re-raise `exc` with the op's creation site appended (reference:
    InsertCallStackInfo, op_call_stack.cc)."""
    stack = getattr(op, "_creation_stack", None)
    note = "\n  [operator %s error]" % op.type
    if stack:
        note += "\n  op created at:\n    " + "\n    ".join(stack)
    if isinstance(exc, EnforceNotMet):
        raise type(exc)(str(exc) + note) from exc
    raise RuntimeError(str(exc) + note) from exc
