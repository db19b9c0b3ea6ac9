"""SSD = the intra-chunk CUDA kernel (``csrc/ssd.cu``) + the cross-chunk
recurrence, the PyTorch port of ``repro.kernels.ssd.ops``.

``ssd_chunked_cuda`` has the contract of ``models.ssm.ssd_chunked``
(y, final_state) but computes the per-chunk work in the kernel; the
carried (H, N, P) state is combined outside, by a sequential scan
(``recurrence="scan"``) or by a log-depth prefix combine
(``recurrence="associative"``): the (decay, state) pairs form a
semigroup, (d2, s2) o (d1, s1) = (d1 d2, d2 s1 + s2).

``ssd_intra_chunk`` runs the plain version (``ref.py``) on CPU tensors;
on CUDA tensors it launches the kernel on the current stream or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
MAX_CHUNK = 256  # rows of a chunk the kernel's in-block scan covers (2 a thread)


def _check(x, dt, b, c, a, d_skip):
    bc, h, q, p = x.shape
    g, n = b.shape[1], b.shape[3]
    for name, t in (("dt", dt), ("b", b), ("c", c), ("a", a), ("d_skip", d_skip)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the SSD kernel takes float32 or bfloat16 x, not {x.dtype}")
    for name, t in (("b", b), ("c", c)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    for name, t in (("dt", dt), ("a", a), ("d_skip", d_skip)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
    if tuple(dt.shape) != (bc, h, q):
        raise ValueError(f"dt must be {(bc, h, q)}, got {tuple(dt.shape)}")
    if tuple(b.shape) != (bc, g, q, n) or tuple(c.shape) != (bc, g, q, n):
        raise ValueError(f"b and c must both be {(bc, g, q, n)}, got {tuple(b.shape)}, {tuple(c.shape)}")
    if tuple(a.shape) != (h,) or tuple(d_skip.shape) != (h,):
        raise ValueError(f"a and d_skip must be ({h},)")
    if g < 1 or h % g:
        raise ValueError(f"H={h} must be a multiple of the group count G={g}")
    if max(h, bc * g) > 65535:
        raise ValueError(f"H={h} and BC*G={bc * g} must be at most 65535 (grid dimensions)")
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"chunk {q} must lie in [1, {MAX_CHUNK}]")
    for name, t in (("x", x), ("dt", dt), ("b", b), ("c", c), ("a", a), ("d_skip", d_skip)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd_intra_chunk(
    x: torch.Tensor,       # (BC, H, Q, P)
    dt: torch.Tensor,      # (BC, H, Q) fp32
    b: torch.Tensor,       # (BC, G, Q, N)
    c: torch.Tensor,       # (BC, G, Q, N)
    a: torch.Tensor,       # (H,) fp32
    d_skip: torch.Tensor,  # (H,) fp32
):
    """Returns (y (BC,H,Q,P) in x's dtype, state (BC,H,N,P) fp32,
    cum (BC,H,Q) fp32): the function of ``ref.ssd_intra_chunk_ref``."""
    if x.device.type == "cpu":
        return ssd_intra_chunk_ref(x, dt, b, c, a, d_skip)
    if x.device.type != "cuda":
        raise ValueError(f"the SSD kernel runs on CPU or CUDA tensors, not {x.device}")
    _check(x, dt, b, c, a, d_skip)
    bc, h, q, p = x.shape
    g, n = b.shape[1], b.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((bc, h, n, p), dtype=torch.float32, device=x.device)
    cum = torch.empty((bc, h, q), dtype=torch.float32, device=x.device)
    fn = K.kernel_function("ssd", "ssd_intra_chunk", _ARGTYPES)
    code = fn(
        _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a.data_ptr(), d_skip.data_ptr(), y.data_ptr(), state.data_ptr(), cum.data_ptr(),
        bc, h, g, q, p, n, torch.cuda.current_stream(x.device).cuda_stream,
    )
    K.check_launch("ssd", code)
    K.LAUNCHES["ssd"] += 1
    return y, state, cum


def _combine(left, right):
    d1, s1 = left
    d2, s2 = right
    return d1 * d2, d2[..., None, None] * s1 + s2


def _associative_scan(decays, states):
    """Inclusive prefix of ``_combine`` over axis 0 in log2(nc) rounds
    (each element combined with the one ``off`` before it)."""
    off = 1
    while off < decays.shape[0]:
        d, s = _combine((decays[:-off], states[:-off]), (decays[off:], states[off:]))
        decays = torch.cat([decays[:off], d])
        states = torch.cat([states[:off], s])
        off *= 2
    return decays, states


def _ssd_chunked(intra, x, dt, a, b_mat, c_mat, d_skip, *, chunk, initial_state, recurrence):
    if recurrence not in ("scan", "associative"):
        raise ValueError(f"recurrence={recurrence!r}; expected 'scan' or 'associative'")
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    f32 = torch.float32

    # (B, S, ...) -> (B*nc, head-major, Q, ...)
    xk = x.reshape(bsz, nc, chunk, h, p).permute(0, 1, 3, 2, 4).reshape(bsz * nc, h, chunk, p)
    dtk = dt.float().reshape(bsz, nc, chunk, h).permute(0, 1, 3, 2).reshape(bsz * nc, h, chunk)
    bk = b_mat.reshape(bsz, nc, chunk, g, n).permute(0, 1, 3, 2, 4).reshape(bsz * nc, g, chunk, n)
    ck = c_mat.reshape(bsz, nc, chunk, g, n).permute(0, 1, 3, 2, 4).reshape(bsz * nc, g, chunk, n)

    y_intra, states, cum = intra(
        xk.contiguous(), dtk.contiguous(), bk.contiguous(), ck.contiguous(),
        a.float().contiguous(), d_skip.float().contiguous(),
    )
    y_intra = y_intra.reshape(bsz, nc, h, chunk, p)
    states = states.reshape(bsz, nc, h, n, p)
    cum = cum.reshape(bsz, nc, h, chunk)
    chunk_decay = torch.exp(cum[..., -1])  # (B, nc, H)

    s0 = (
        torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
        if initial_state is None
        else initial_state.float()
    )
    decays = chunk_decay.movedim(1, 0)  # (nc, B, H)
    sts = states.movedim(1, 0)  # (nc, B, H, N, P)
    if recurrence == "associative":
        # fold the initial state into the first element
        sts = torch.cat([(sts[0] + s0 * decays[0][..., None, None])[None], sts[1:]])
        _, ps = _associative_scan(decays, sts)
        final = ps[-1]
        prev = torch.cat([s0[None], ps[:-1]])  # state entering each chunk
    else:
        carry, prev = s0, []
        for z in range(nc):
            prev.append(carry)
            carry = carry * decays[z][..., None, None] + sts[z]
        final, prev = carry, torch.stack(prev)
    prev_states = prev.movedim(0, 1)  # (B, nc, H, N, P)

    # inter-chunk output: C_i . S_prev . exp(cum_i), shaped (B,nc,H,Q,P)
    ch = c_mat.reshape(bsz, nc, chunk, g, n).repeat_interleave(h // g, dim=3)
    y_inter = torch.einsum("bzqhn,bzhnp,bzhq->bzhqp", ch.float(), prev_states, torch.exp(cum))
    # y_intra is already rounded to x's dtype, as the JAX wrapper's is
    y = y_intra.float() + y_inter
    y = y.permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p).to(x.dtype)
    return y, final


def ssd_chunked_cuda(x, dt, a, b_mat, c_mat, d_skip, *, chunk: int,
                     initial_state=None, recurrence: str = "scan"):
    """Same contract as ``models.ssm.ssd_chunked`` (y in x's dtype,
    final_state (B,H,N,P) fp32), the intra-chunk work in the kernel.

    x: (B,S,H,P); dt: (B,S,H) post-softplus; a: (H,) negative; b_mat,
    c_mat: (B,S,G,N); d_skip: (H,); S a multiple of ``chunk``."""
    return _ssd_chunked(
        ssd_intra_chunk, x, dt, a, b_mat, c_mat, d_skip, chunk=chunk,
        initial_state=initial_state, recurrence=recurrence,
    )
