"""Flash attention: the Hopper kernels' wrappers and their plain PyTorch
versions (counterpart: `paddle_tpu/ops/pallas/flash_attention.py`).

Three CUDA kernels in ``csrc/flash_attention.cu`` replace the three Pallas
kernels of the reference:

- ``fa_forward``  for ``_fwd_kernel``     (``o`` and the per-row ``lse``);
- ``fa_bwd_dkv``  for ``_bwd_dkv_kernel`` (``dk`` and ``dv``);
- ``fa_bwd_dq``   for ``_bwd_dq_kernel``  (``dq``).

Semantics, shared by the kernels and the plain versions, on inputs
``q`` [B, H, Sq, D], ``k``/``v`` [B, H, Sk, D] and an optional additive
``bias`` [B*H, Sk] (float32, no gradient); the plain versions also take
flattened [BH, S, D] inputs:

- ``S = q kᵀ · sm_scale + bias``, with ``S = -1e30`` where ``col > row``
  when causal (the reference's constant, not -inf);
- softmax statistics in float32: ``lse = m + log(l_safe)`` with
  ``l_safe = 1`` where ``l == 0``; ``l`` sums the pre-dropout
  probabilities, and dropout scales only the numerator;
- the dropout keep mask is the reference's murmur3-finalizer hash of the
  global (row, col, bh, seed) coordinates, bh = b·H + h, bit for bit, so
  results do not depend on tiling;
- ``o``, ``dq``, ``dk``, ``dv`` in the input dtype, computed in float32.
  On the card, the bfloat16 forward and dQ kernels round P and dS to
  bfloat16 before their second product (tensor cores), so their results
  are close to the plain version's but not bit-equal; the float32 kernels
  and dK/dV keep P and dS in float32.

`flash_attention` is the public entry: it pads S to block multiples with
a -1e30 bias on the padded keys (as the reference does), and its backward
is a `torch.autograd.Function`. ``impl="auto"`` launches the kernels for
CUDA tensors and runs the plain versions for CPU tensors; ``"kernel"``
raises on the CPU; ``"reference"`` runs the plain versions anywhere.

The kernels read q, k, v and do through their strides and write o, dq, dk
and dv as [B, H, S, D] views of [B, S, H, D] tensors, so the trainer's
head split and merge (``reshape(B, S, H, D).transpose(1, 2)`` and back)
copy nothing. An operand is copied only where the kernel cannot read it in
place: its last dimension is strided, or (bfloat16, read by TMA) a stride
or its base is not 16-byte aligned or D is not a multiple of 8.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

__all__ = ["flash_attention", "pad_and_flatten", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "flash_attention_delta",
           "flash_attention_fwd_reference", "flash_attention_bwd_reference",
           "flash_attention_bwd_dkv_reference",
           "flash_attention_bwd_dq_reference", "dropout_keep_mask",
           "reference_attention"]

_NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF
_MAX_HEAD_DIM = 128
#: input dtype -> the kernels' dtype argument
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(q, k, v, key_bias=None, causal=False,
                        sm_scale=None):
    """Naive attention over [B, H, S, D] inputs, computed in float32
    (golden reference); returns q's dtype."""
    D = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if key_bias is not None:
        s = s + key_bias[:, None, None, :].float()
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        rows = torch.arange(Sq, device=s.device)[:, None]
        cols = torch.arange(Sk, device=s.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _keep_threshold(p_drop):
    return min(int(p_drop * 4294967296.0), _MASK32)


def dropout_keep_mask(seed, BH, Sq, Sk, p_drop, device=None):
    """The reference's `_dropout_mask` over the whole [BH, Sq, Sk] lattice:
    ``1/(1-p)`` (float32) where kept, 0 where dropped. The uint32 hash runs
    in int64 with ``& 0xFFFFFFFF`` after every multiply, so it is bit-equal
    to the kernel's and the reference's uint32 arithmetic."""
    rows = torch.arange(Sq, dtype=torch.int64, device=device)[None, :, None]
    cols = torch.arange(Sk, dtype=torch.int64, device=device)[None, None, :]
    bh = torch.arange(BH, dtype=torch.int64, device=device)[:, None, None]
    x = ((rows * 0x9E3779B1) & _MASK32) ^ ((cols * 0x85EBCA77) & _MASK32)
    x = x ^ ((bh * 0xC2B2AE3D) & _MASK32) ^ (int(seed) & _MASK32)
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _MASK32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _MASK32
    x = x ^ (x >> 16)
    keep = torch.tensor(1.0 / (1.0 - p_drop), dtype=torch.float32)
    return torch.where(x >= _keep_threshold(p_drop), keep.to(device),
                       torch.zeros((), dtype=torch.float32, device=device))


def _scores(q, k, bias, sm_scale, causal):
    """float32 S = q kᵀ · scale + bias over [..., Sq, Sk] (the bias's
    [BH, Sk] rows in the order of q's leading dims), causal-masked with
    -1e30."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias.float().reshape(*s.shape[:-2], 1, s.shape[-1])
    if causal:
        rows = torch.arange(s.shape[-2], device=s.device)[:, None]
        cols = torch.arange(s.shape[-1], device=s.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, _NEG_INF))
    return s


def _keep_mask(seed, s, p_drop):
    """`dropout_keep_mask` over the lattice of scores s [..., Sq, Sk]."""
    bh = s[..., 0, 0].numel()
    return dropout_keep_mask(seed, bh, s.shape[-2], s.shape[-1], p_drop,
                             device=s.device).reshape(s.shape)


def flash_attention_fwd_reference(q, k, v, bias=None, seed=0, *, sm_scale,
                                  causal=False, dropout_p=0.0):
    """Plain version of the forward kernel on [..., S, D] inputs, with full
    [..., Sq, Sk] float32 matrices. Returns ``(o, lse)``: o in q's dtype,
    lse [..., Sq] float32."""
    s = _scores(q, k, bias, sm_scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    if dropout_p > 0.0:
        p = p * _keep_mask(seed, s, dropout_p)
    # stored as [B, S, H, D], as the kernel writes o
    o = torch.einsum("...hqk,...hkd->...qhd", p, v.float()).contiguous()
    o = (o / l_safe.transpose(-3, -2)).transpose(-3, -2)
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def _probs(q, k, bias, seed, lse, do, v, sm_scale, causal, dropout_p):
    """The backward kernels' recompute: P = exp(S - lse) and
    dP = (dO Vᵀ)∘M, and Z = P∘M (float32)."""
    s = _scores(q, k, bias, sm_scale, causal)
    p = torch.exp(s - lse.float().reshape(s.shape[:-1])[..., None])
    dp = torch.einsum("...qd,...kd->...qk", do.float(), v.float())
    if dropout_p > 0.0:
        mask = _keep_mask(seed, s, dropout_p)
        return p, p * mask, dp * mask
    return p, p, dp


def _ds(p, dp, delta, sm_scale):
    """dS = P∘(dP - delta)·scale, delta [..., Sq] as the rows of p."""
    return p * (dp - delta.float().reshape(p.shape[:-1])[..., None]) \
        * sm_scale


def flash_attention_bwd_dkv_reference(q, k, v, bias, seed, do, lse, delta, *,
                                      sm_scale, causal=False, dropout_p=0.0):
    """Plain version of the dK/dV kernel: ``dV = Zᵀ dO`` and
    ``dK = dSᵀ Q`` with ``dS = P∘(dP - delta)·scale``. Returns
    ``(dk, dv)`` in the dtypes of k and v."""
    p, z, dp = _probs(q, k, bias, seed, lse, do, v, sm_scale, causal,
                      dropout_p)
    ds = _ds(p, dp, delta, sm_scale)
    dv = torch.einsum("...qk,...qd->...kd", z, do.float())
    dk = torch.einsum("...qk,...qd->...kd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, bias, seed, do, lse, delta, *,
                                     sm_scale, causal=False, dropout_p=0.0):
    """Plain version of the dQ kernel: ``dQ = dS K``, in q's dtype."""
    p, _, dp = _probs(q, k, bias, seed, lse, do, v, sm_scale, causal,
                      dropout_p)
    ds = _ds(p, dp, delta, sm_scale)
    return torch.einsum("...qk,...kd->...qd", ds, k.float()).to(q.dtype)


def flash_attention_bwd_reference(q, k, v, bias, seed, o, lse, do, *,
                                  sm_scale, causal=False, dropout_p=0.0):
    """Plain version of the whole backward on [..., S, D] inputs:
    ``delta = rowsum(dO∘O)`` from the stored ``o``, then both kernels'
    plain versions. Returns ``(dq, dk, dv)`` in the dtypes of q, k, v."""
    kw = dict(sm_scale=sm_scale, causal=causal, dropout_p=dropout_p)
    delta = flash_attention_delta(o, do)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, bias, seed, do, lse,
                                               delta, **kw)
    dq = flash_attention_bwd_dq_reference(q, k, v, bias, seed, do, lse,
                                          delta, **kw)
    return dq, dk, dv


def flash_attention_delta(o, do):
    """rowsum(dO∘O) in float32, [..., Sq] (outside any kernel, as in the
    reference's `_bwd_call`)."""
    return (do.float() * o.float()).sum(dim=-1)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

def _kernel_lib():
    from . import _build

    lib = _build.load("flash_attention")
    if lib.fa_forward.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        u32 = ctypes.c_uint32
        # dtype, causal, dropout, B, H, Sq, Sk, D, sm_scale, seed, thresh,
        # keep_scale; then the tensors, the strides and the stream
        common = [i32] * 8 + [f32, i32, u32, f32]
        lib.fa_forward.argtypes = common + [ptr] * 6 + [ptr, ptr]
        lib.fa_bwd_dkv.argtypes = common + [ptr] * 9 + [ptr, ptr]
        lib.fa_bwd_dq.argtypes = common + [ptr] * 8 + [ptr, ptr]
        for fn in (lib.fa_forward, lib.fa_bwd_dkv, lib.fa_bwd_dq):
            fn.restype = i32
    return lib


def _tma_readable(t):
    """Whether TMA can read t in place: 16-byte-aligned base and batch,
    head and row strides (those of size-1 dimensions never apply)."""
    esz = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or (st * esz) % 16 == 0
        for n, st in zip(t.shape[:3], t.stride()[:3]))


def _kernel_inputs(ts, tensor_cores):
    """The [B, H, S, D] operands as the kernels read them: as they are
    where possible; a contiguous copy where d is strided or, for the
    tensor-core kernels, where TMA cannot read them; all zero-padded to a
    multiple of 8 in D for the tensor-core kernels where D is not one."""
    if tensor_cores and ts[0].shape[-1] % 8:
        pad = -ts[0].shape[-1] % 8
        return [F.pad(t, (0, pad)) for t in ts]
    return [t if t.stride(-1) == 1 and (not tensor_cores or _tma_readable(t))
            else t.contiguous() for t in ts]


def _strides(*ts):
    """The (batch, head, row) element strides of each operand, as the C
    functions take them; a size-1 dimension gets 16 bytes (never used, and
    valid for a TMA map)."""
    out = []
    for t in ts:
        unit = 16 // t.element_size()
        out += [st if n > 1 else unit
                for n, st in zip(t.shape[:3], t.stride()[:3])]
    return (ctypes.c_longlong * len(out))(*out)


def _empty_bshd(t, S):
    """An uninitialised [B, H, S, D] tensor like t, laid out as
    [B, S, H, D]: what ``transpose(1, 2).reshape(B, S, H * D)`` reads
    without a copy."""
    B, H, _, D = t.shape
    return torch.empty((B, S, H, D), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def _kernel_args(q, k, v, bias, seed, extra=(), *, tensor_cores, sm_scale,
                 causal, dropout_p):
    """Check what the kernels take and prepare the operands q, k, v and
    `extra` (`_kernel_inputs`). Returns the leading C arguments and the
    prepared operands."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError("%s is on %s, q on %s" % (name, t.device, dev))
    kind = _DTYPES.get(q.dtype)
    if kind is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("kernels take float32 or bfloat16 q/k/v of one "
                        "dtype, got %s/%s/%s" % (q.dtype, k.dtype, v.dtype))
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError("kernels take q [B, H, Sq, D] and k, v "
                         "[B, H, Sk, D], got %s, %s, %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if D > _MAX_HEAD_DIM:
        raise ValueError("kernels take head_dim <= %d, got %d"
                         % (_MAX_HEAD_DIM, D))
    if bias is not None:
        if bias.dtype != torch.float32:
            raise TypeError("bias must be float32, got %s" % bias.dtype)
        if not bias.is_contiguous() or bias.numel() != B * H * Sk:
            raise ValueError("bias must be a contiguous [B*H, Sk] tensor")
    ops = _kernel_inputs((q, k, v) + tuple(extra), tensor_cores)
    thresh = _keep_threshold(dropout_p) if dropout_p > 0.0 else 0
    keep = 1.0 / (1.0 - dropout_p) if dropout_p > 0.0 else 1.0
    return [kind, int(causal), int(dropout_p > 0.0), B, H, Sq, Sk,
            ops[0].shape[-1], float(sm_scale),
            int(seed) if dropout_p > 0.0 else 0, thresh, keep], ops


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_rc(rc, name):
    if rc != 0:
        raise RuntimeError("flash attention %s kernel launch failed: CUDA "
                           "error %d" % (name, rc))


def _check_grad_inputs(q, do, lse, delta):
    if do.device != q.device or do.shape != q.shape:
        raise ValueError("do must be %s on %s" % (tuple(q.shape), q.device))
    for name, t in (("lse", lse), ("delta", delta)):
        if t.device != q.device or not t.is_contiguous() \
                or t.numel() != q.shape[0] * q.shape[1] * q.shape[2]:
            raise ValueError("%s must be a contiguous [B*H, Sq] tensor on %s"
                             % (name, q.device))
    if do.dtype != q.dtype or lse.dtype != torch.float32 \
            or delta.dtype != torch.float32:
        raise TypeError("do must be %s, lse and delta float32" % q.dtype)


def _unpad(t, D):
    return t if t.shape[-1] == D else t[..., :D]


def flash_attention_fwd(q, k, v, bias=None, seed=0, *, sm_scale,
                        causal=False, dropout_p=0.0, impl="auto"):
    """Forward on [B, H, S, D] inputs (any strides): ``(o, lse)``, from
    the kernel or the plain version as `impl` says. The kernel's o is a
    view of a [B, S, H, D] tensor and its lse is [B, H, Sq]."""
    kw = dict(sm_scale=sm_scale, causal=causal, dropout_p=dropout_p)
    if _use_reference(q, impl):
        return flash_attention_fwd_reference(q, k, v, bias, seed, **kw)
    head, (qk, kk, vk) = _kernel_args(
        q, k, v, bias, seed, tensor_cores=q.dtype == torch.bfloat16, **kw)
    o = _empty_bshd(qk, qk.shape[2])
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    rc = _kernel_lib().fa_forward(
        *head, qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), _ptr(bias),
        o.data_ptr(), lse.data_ptr(), _strides(qk, kk, vk, o),
        torch.cuda.current_stream(q.device).cuda_stream)
    _check_rc(rc, "forward")
    flash_attention.fwd_launches += 1
    return _unpad(o, q.shape[-1]), lse


def flash_attention_bwd_dkv(q, k, v, bias, seed, do, lse, delta, *,
                            sm_scale, causal=False, dropout_p=0.0,
                            impl="auto"):
    """``(dk, dv)`` from the dK/dV kernel or its plain version."""
    kw = dict(sm_scale=sm_scale, causal=causal, dropout_p=dropout_p)
    if _use_reference(q, impl):
        return flash_attention_bwd_dkv_reference(q, k, v, bias, seed, do,
                                                 lse, delta, **kw)
    _check_grad_inputs(q, do, lse, delta)
    head, (qk, kk, vk, dok) = _kernel_args(q, k, v, bias, seed, (do,),
                                           tensor_cores=False, **kw)
    dk, dv = _empty_bshd(kk, kk.shape[2]), _empty_bshd(vk, vk.shape[2])
    rc = _kernel_lib().fa_bwd_dkv(
        *head, qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), _ptr(bias),
        dok.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _strides(qk, kk, vk, dok, dk, dv),
        torch.cuda.current_stream(q.device).cuda_stream)
    _check_rc(rc, "dkv")
    flash_attention.dkv_launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, bias, seed, do, lse, delta, *, sm_scale,
                           causal=False, dropout_p=0.0, impl="auto"):
    """``dq`` from the dQ kernel or its plain version."""
    kw = dict(sm_scale=sm_scale, causal=causal, dropout_p=dropout_p)
    if _use_reference(q, impl):
        return flash_attention_bwd_dq_reference(q, k, v, bias, seed, do, lse,
                                                delta, **kw)
    _check_grad_inputs(q, do, lse, delta)
    head, (qk, kk, vk, dok) = _kernel_args(
        q, k, v, bias, seed, (do,), tensor_cores=q.dtype == torch.bfloat16,
        **kw)
    dq = _empty_bshd(qk, qk.shape[2])
    rc = _kernel_lib().fa_bwd_dq(
        *head, qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), _ptr(bias),
        dok.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(qk, kk, vk, dok, dq),
        torch.cuda.current_stream(q.device).cuda_stream)
    _check_rc(rc, "dq")
    flash_attention.dq_launches += 1
    return _unpad(dq, q.shape[-1])


def flash_attention_bwd(q, k, v, bias, seed, o, lse, do, *, sm_scale,
                        causal=False, dropout_p=0.0, impl="auto"):
    """Backward on [B, H, S, D] inputs (any strides): ``delta =
    rowsum(dO∘O)`` (a torch op, as in the reference), then the dK/dV and
    dQ kernels, or the plain versions, as `impl` says. Returns
    ``(dq, dk, dv)``."""
    kw = dict(sm_scale=sm_scale, causal=causal, dropout_p=dropout_p,
              impl=impl)
    delta = flash_attention_delta(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, bias, seed, do, lse, delta,
                                     **kw)
    dq = flash_attention_bwd_dq(q, k, v, bias, seed, do, lse, delta, **kw)
    return dq, dk, dv


def _use_reference(q, impl):
    if impl not in ("auto", "kernel", "reference"):
        raise ValueError("impl must be auto|kernel|reference, got %r"
                         % (impl,))
    on_card = q.device.type == "cuda"
    if impl == "reference" or (impl == "auto" and not on_card):
        return True
    if not on_card:
        raise ValueError("impl='kernel' needs CUDA tensors, q is on %s"
                         % (q.device,))
    return False


# ---------------------------------------------------------------------------
# Public entry: padding wrapper + autograd
# ---------------------------------------------------------------------------

class _FlashCore(torch.autograd.Function):
    """The reference's `_flash_core` custom_vjp: the dropout seed and the
    static settings are not differentiable, and the bias gets no gradient
    (the reference returns a zero cotangent for it; here the bias arrives
    detached, so its gradient is None)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, sm_scale, causal, dropout_p,
                impl):
        o, lse = flash_attention_fwd(q, k, v, bias, seed, sm_scale=sm_scale,
                                     causal=causal, dropout_p=dropout_p,
                                     impl=impl)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.settings = (seed, sm_scale, causal, dropout_p, impl)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        seed, sm_scale, causal, dropout_p, impl = ctx.settings
        dq, dk, dv = flash_attention_bwd(
            q, k, v, bias, seed, o, lse, do.to(q.dtype), sm_scale=sm_scale,
            causal=causal, dropout_p=dropout_p, impl=impl)
        return dq, dk, dv, None, None, None, None, None, None


def _pad_to(x, dim, mult, value=0.0):
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=dim)


def pad_and_flatten(q, k, v, key_bias=None, block_q=128, block_k=128):
    """The kernels' inputs, as the reference's wrapper makes them: q, k, v
    [B, H, S, D] with S padded to a multiple of ``min(block, roundup8(S))``
    (q, k and v themselves, views and all, where S needs no padding), and
    the key bias flattened to float32 [B*H, Sk] with -1e30 on the padded
    keys (a zero bias is made where keys are padded and there is none)."""
    B, H, Sq = q.shape[:3]
    Sk = k.shape[2]
    block_q = min(block_q, -(-Sq // 8) * 8)
    block_k = min(block_k, -(-Sk // 8) * 8)
    qf = _pad_to(q, 2, block_q)
    kf = _pad_to(k, 2, block_k)
    vf = _pad_to(v, 2, block_k)
    bias = key_bias
    if (-Sk) % block_k and bias is None:
        bias = torch.zeros((B, Sk), dtype=torch.float32, device=q.device)
    if bias is not None:
        bias = _pad_to(bias.detach().float(), 1, block_k, value=_NEG_INF)
        # one bias row per (b, h), as the reference repeats it
        bias = bias.repeat_interleave(H, dim=0).contiguous()
    return qf, kf, vf, bias


def flash_attention(q, k, v, key_bias=None, causal=False, sm_scale=None,
                    block_q=128, block_k=128, dropout_p=0.0,
                    dropout_seed=None, impl="auto"):
    """Blockwise (flash) attention.

    q: [B, H, Sq, D]; k, v: [B, H, Sk, D]; key_bias: optional [B, Sk]
    additive bias on keys (non-differentiable). Returns [B, H, Sq, D] in
    q's dtype. dropout_p > 0 drops attention probabilities inside the
    kernels with the reference's hash of (dropout_seed, coordinates);
    dropout_seed (an int32 value) is then required.

    block_q/block_k set the padding of S, as in the reference (blocks of
    ``min(block, roundup8(S))``); the kernels tile on their own.
    impl: "auto" (kernels on the card, plain version on the CPU),
    "kernel" (raises for CPU tensors) or "reference" (plain anywhere).
    ``flash_attention.fwd_launches``, ``.dkv_launches`` and
    ``.dq_launches`` count the kernels' launches. q, k and v may be
    strided views (the trainer's heads of one qkv tensor); where S needs
    no padding they reach the kernels as they are, and the result is a
    view of a [B, Sq, H, D] tensor."""
    Sq, D = q.shape[2], q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    dropout_p = float(dropout_p)
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError("dropout_p must be in [0, 1): %r" % dropout_p)
    seed = 0
    if dropout_p > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_p > 0 requires dropout_seed")
        seed = int(dropout_seed)
        # the reference casts the seed to int32, then to uint32 in-kernel
        seed = (seed + 2 ** 31) % 2 ** 32 - 2 ** 31
    _use_reference(q, impl)  # validate impl and device before any work
    qf, kf, vf, bias = pad_and_flatten(q, k, v, key_bias, block_q, block_k)
    o, _ = _FlashCore.apply(qf, kf, vf, bias, seed, float(sm_scale),
                            bool(causal), dropout_p, impl)
    return o if o.shape[2] == Sq else o[:, :, :Sq]


flash_attention.fwd_launches = 0
flash_attention.dkv_launches = 0
flash_attention.dq_launches = 0
