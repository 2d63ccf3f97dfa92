"""Ragged paged attention: the Hopper kernel's wrapper and its plain
PyTorch version (counterpart:
`paddle_tpu/ops/pallas/ragged_paged_attention.py`).

Semantics (shared by kernel and plain version):

- ``q``             [S, Q, Hq, D] — Q is the padded per-sequence query
                    length (1 for pure decode buckets);
- ``k_pages``/``v_pages`` [P, page_size, Hkv, D] — the paged KV cache;
                    query head h reads kv head h // (Hq // Hkv) (GQA);
- ``block_tables``  [S, pages_per_seq] int32 — page ids per sequence,
                    in order; entries past the live context must still
                    be valid page indices (pad with 0);
- ``context_lens``  [S] int32 — tokens of the sequence already written
                    to the cache, including this call's query tokens;
- ``q_lens``        [S] int32 — valid query rows per sequence (None =
                    all Q rows valid). Row i < q_lens[s] has absolute
                    position ``context_lens[s] - q_lens[s] + i`` and
                    attends every cached position <= its own. Rows
                    >= q_lens[s] (and inactive slots, q_lens == 0)
                    return exact zeros.
- ``k_scale``/``v_scale`` [P, page_size] float32, both or neither —
                    per-slot dequantization scales of int8 pages.

The wrapper launches the CUDA kernel (``csrc/ragged_paged_attention.cu``)
for tensors on the card and the plain version for tensors on the CPU or
when ``impl="reference"``. A CUDA tensor never reaches the plain version
otherwise: the kernel launches or the call raises. Inference only.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["ragged_paged_attention", "ragged_paged_attention_reference"]

_NEG_INF = -1e30  # the reference's mask constant (not -inf)

#: page dtype -> the kernel's page_kind argument
_PAGE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3}
_MAX_HEAD_DIM = 128


def _check_args(q, k_pages, v_pages, block_tables, context_lens, q_lens,
                k_scale=None, v_scale=None):
    S, Q, Hq, D = q.shape
    P, page_size, Hkv, Dk = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError("k_pages %s != v_pages %s"
                         % (tuple(k_pages.shape), tuple(v_pages.shape)))
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if k_scale is not None:
        if tuple(k_scale.shape) != (P, page_size) or \
                tuple(v_scale.shape) != (P, page_size):
            raise ValueError(
                "k_scale/v_scale must be [num_pages, page_size] = %s, "
                "got %s / %s" % ((P, page_size), tuple(k_scale.shape),
                                 tuple(v_scale.shape)))
    if Dk != D:
        raise ValueError("head_dim mismatch: q %d vs pages %d" % (D, Dk))
    if Hq % Hkv != 0:
        raise ValueError("q heads %d not a multiple of kv heads %d"
                         % (Hq, Hkv))
    if block_tables.ndim != 2 or block_tables.shape[0] != S:
        raise ValueError("block_tables must be [S, pages_per_seq], got %s"
                         % (tuple(block_tables.shape),))
    if tuple(context_lens.shape) != (S,):
        raise ValueError("context_lens must be [S], got %s"
                         % (tuple(context_lens.shape),))
    if q_lens is not None and tuple(q_lens.shape) != (S,):
        raise ValueError("q_lens must be [S], got %s"
                         % (tuple(q_lens.shape),))


def ragged_paged_attention_reference(q, k_pages, v_pages, block_tables,
                                     context_lens, q_lens=None, *,
                                     sm_scale=None, k_scale=None,
                                     v_scale=None):
    """Gather-then-mask plain version with the exact kernel semantics.

    The gather spans the FULL block table, not the batch's max context,
    so per-row results are independent of how the batch was packed.
    int8 pages are multiplied by their per-slot scales in float32 before
    the attention math."""
    _check_args(q, k_pages, v_pages, block_tables, context_lens, q_lens,
                k_scale, v_scale)
    S, Q, Hq, D = q.shape
    P, page_size, Hkv, _ = k_pages.shape
    G = Hq // Hkv
    npages = block_tables.shape[1]
    kvmax = npages * page_size
    dev = q.device
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q_lens is None:
        q_lens = torch.full((S,), Q, dtype=torch.int32, device=dev)
    tables = block_tables.long()

    # [S, kvmax, Hkv, D] — every sequence's pages, in table order
    k = k_pages[tables].reshape(S, kvmax, Hkv, D)
    v = v_pages[tables].reshape(S, kvmax, Hkv, D)
    if k_scale is not None:
        ks = k_scale.float()[tables].reshape(S, kvmax)[:, :, None, None]
        vs = v_scale.float()[tables].reshape(S, kvmax)[:, :, None, None]
        k = k.float() * ks
        v = v.float() * vs

    qf = q.float().reshape(S, Q, Hkv, G, D)
    s = torch.einsum("sqhgd,skhd->shgqk", qf, k.float()) * sm_scale

    kpos = torch.arange(kvmax, device=dev).view(1, 1, 1, 1, kvmax)
    qrow = torch.arange(Q, device=dev).view(1, 1, 1, Q, 1)
    ql = q_lens.long().view(S, 1, 1, 1, 1)
    qpos = context_lens.long().view(S, 1, 1, 1, 1) - ql + qrow
    valid = (kpos <= qpos) & (qrow < ql)
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))

    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid, p, torch.zeros_like(p))  # fully-masked rows
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("shgqk,skhd->shgqd", p, v.float())
    o = o / torch.where(l == 0.0, torch.ones_like(l), l)
    # [S, Hkv, G, Q, D] -> [S, Q, Hq, D]
    return o.permute(0, 3, 1, 2, 4).reshape(S, Q, Hq, D).to(q.dtype)


def _kernel_lib():
    from . import _build

    lib = _build.load("ragged_paged_attention")
    if lib.rpa_forward.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rpa_forward.argtypes = [i32] + [ptr] * 10 + [i32] * 7 + [
            ctypes.c_float, ptr]
        lib.rpa_forward.restype = i32
        lib.rpa_workspace_floats.argtypes = [i32] * 8
        lib.rpa_workspace_floats.restype = ctypes.c_longlong
    return lib


def _launch_kernel(q, k_pages, v_pages, block_tables, context_lens, q_lens,
                   sm_scale, k_scale, v_scale):
    """Validate what the kernel takes, then launch it on the current
    stream. Raises on anything else; never computes on the host."""
    dev = q.device
    named = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
             ("block_tables", block_tables), ("context_lens", context_lens),
             ("q_lens", q_lens)]
    if k_scale is not None:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in named:
        if t.device != dev:
            raise ValueError("%s is on %s, q on %s" % (name, t.device, dev))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    if q.dtype != torch.float32:
        raise TypeError("kernel takes float32 q, got %s" % q.dtype)
    for name in ("block_tables", "context_lens", "q_lens"):
        if dict(named)[name].dtype != torch.int32:
            raise TypeError("%s must be int32" % name)
    kind = _PAGE_KINDS.get(k_pages.dtype)
    if kind is None or v_pages.dtype != k_pages.dtype:
        raise TypeError("kernel takes float32/bfloat16/float16/int8 pages, "
                        "got %s/%s" % (k_pages.dtype, v_pages.dtype))
    if (k_pages.dtype == torch.int8) != (k_scale is not None):
        raise ValueError("the kernel takes k_scale/v_scale exactly when the "
                         "pages are int8")
    if k_scale is not None and (k_scale.dtype != torch.float32
                                or v_scale.dtype != torch.float32):
        raise TypeError("k_scale/v_scale must be float32")
    S, Q, Hq, D = q.shape
    P, page_size, Hkv, _ = k_pages.shape
    if D > _MAX_HEAD_DIM:
        raise ValueError("kernel takes head_dim <= %d, got %d"
                         % (_MAX_HEAD_DIM, D))
    lib = _kernel_lib()
    pps = block_tables.shape[1]
    floats = lib.rpa_workspace_floats(kind, S, Q, Hq, Hkv, D, page_size, pps)
    if floats < 0:
        raise ValueError("the kernel cannot take q %s with pages %s and a "
                         "%d-page table" % (tuple(q.shape),
                                            tuple(k_pages.shape), pps))
    out = torch.empty_like(q)
    work = torch.empty((floats,), dtype=torch.float32, device=dev)
    scale_ptr = (lambda t: t.data_ptr() if t is not None else None)
    rc = lib.rpa_forward(
        kind, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        scale_ptr(k_scale), scale_ptr(v_scale), block_tables.data_ptr(),
        context_lens.data_ptr(), q_lens.data_ptr(), out.data_ptr(),
        work.data_ptr(), S, Q, Hq, Hkv, D, page_size,
        pps, float(sm_scale), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("ragged_paged_attention kernel launch failed: "
                           "CUDA error %d" % rc)
    ragged_paged_attention.launches += 1
    if kind == _PAGE_KINDS[torch.int8]:
        ragged_paged_attention.quant_launches += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, block_tables,
                           context_lens, q_lens=None, *, sm_scale=None,
                           impl="auto", k_scale=None, v_scale=None):
    """Paged attention over mixed-length sequences through a block table
    (see the module docstring for the argument contract).

    impl: "auto" = the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU; "kernel" = the CUDA kernel (raises
    for CPU tensors); "reference" = the plain version anywhere.

    ``ragged_paged_attention.launches`` counts kernel calls and
    ``ragged_paged_attention.quant_launches`` the int8-page ones among
    them; the plain version counts nothing. One call is two CUDA launches:
    the page chunks, then their merge."""
    _check_args(q, k_pages, v_pages, block_tables, context_lens, q_lens,
                k_scale, v_scale)
    if impl not in ("auto", "kernel", "reference"):
        raise ValueError("impl must be auto|kernel|reference, got %r"
                         % (impl,))
    on_card = q.device.type == "cuda"
    if impl == "reference" or (impl == "auto" and not on_card):
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, block_tables, context_lens, q_lens,
            sm_scale=sm_scale, k_scale=k_scale, v_scale=v_scale)
    if not on_card:
        raise ValueError("impl='kernel' needs CUDA tensors, q is on %s"
                         % (q.device,))
    S, Q, _, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q_lens is None:
        q_lens = torch.full((S,), Q, dtype=torch.int32, device=q.device)
    return _launch_kernel(q, k_pages, v_pages, block_tables, context_lens,
                          q_lens, sm_scale, k_scale, v_scale)


ragged_paged_attention.launches = 0
ragged_paged_attention.quant_launches = 0
