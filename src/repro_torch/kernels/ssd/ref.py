"""Plain PyTorch versions of the Mamba-2 SSD kernel.

* :func:`ssd_ref` -- the naive recurrence, the oracle, op for op with
  the JAX package's ``repro.kernels.ssd.ref.ssd_ref``:

      s_t = exp(dt_t * a) * s_{t-1} + dt_t * B_t x_t^T
      y_t = C_t . s_t + D * x_t

* :func:`ssd_intra_chunk_ref` -- the plain version of the intra-chunk
  kernel (``csrc/ssd.cu``), op for op with the TPU kernel
  ``repro.kernels.ssd.kernel._ssd_chunk_kernel``, batched over
  (chunk, head) where the TPU grid walks them.
* :func:`ssd_chunked_ref` -- the registry's plain ``"ssd"`` op: the
  chunked SSD of ``ops.ssd_chunked_cuda`` with this plain intra-chunk
  version in place of the kernel.
"""
from __future__ import annotations

import torch


def ssd_ref(x, dt, a, b_mat, c_mat, d_skip, *, initial_state=None):
    """x: (B,S,H,P); dt: (B,S,H); a: (H,); b/c: (B,S,G,N); d_skip: (H,).

    Returns (y (B,S,H,P) fp32, final_state (B,H,N,P) fp32).
    """
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    hg = h // g
    xf = x.float()
    dtf = dt.float()
    bh = b_mat.repeat_interleave(hg, dim=2).float()  # (B,S,H,N)
    ch = c_mat.repeat_interleave(hg, dim=2).float()
    state = (
        torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
        if initial_state is None
        else initial_state.float()
    )
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a)  # (B,H)
        state = state * decay[:, :, None, None] + torch.einsum(
            "bh,bhn,bhp->bhnp", dtf[:, t], bh[:, t], xf[:, t]
        )
        y = torch.einsum("bhn,bhnp->bhp", ch[:, t], state)
        ys.append(y + xf[:, t] * d_skip[None, :, None])
    return torch.stack(ys, dim=1), state


def ssd_intra_chunk_ref(
    x: torch.Tensor,       # (BC, H, Q, P)  BC = batch * num_chunks
    dt: torch.Tensor,      # (BC, H, Q)
    b: torch.Tensor,       # (BC, G, Q, N)
    c: torch.Tensor,       # (BC, G, Q, N)
    a: torch.Tensor,       # (H,) negative decay rates
    d_skip: torch.Tensor,  # (H,)
):
    """Per (chunk, head), in fp32: ``cum`` = inclusive cumsum of dt*a
    (the TPU kernel's lower-triangular product); ``y = (C.B^T * decay *
    dt_j).x + D.x`` with ``decay = exp(cum_i - cum_j)`` on the lower
    triangle; ``state = (B * exp(total - cum) * dt)^T.x``.

    Returns (y (BC,H,Q,P) in x's dtype, state (BC,H,N,P) fp32,
    cum (BC,H,Q) fp32)."""
    q = x.shape[2]
    hg = x.shape[1] // b.shape[1]
    f32 = torch.float32
    xf = x.float()
    dtc = dt.float()
    bf = b.float().repeat_interleave(hg, dim=1)  # (BC,H,Q,N): head h reads group h // hg
    cf = c.float().repeat_interleave(hg, dim=1)
    da = dtc * a.float()[None, :, None]  # (BC,H,Q)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    cum = torch.einsum("ij,bhj->bhi", tri.to(f32), da)  # inclusive cumsum
    total = cum[..., -1:]
    decay = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
    cb = torch.einsum("bhin,bhjn->bhij", cf, bf)  # (BC,H,Q,Q)
    w = cb * decay * dtc[..., None, :]
    y = torch.einsum("bhij,bhjp->bhip", w, xf)
    y = y + xf * d_skip.float()[None, :, None, None]
    state_w = torch.exp(total - cum) * dtc  # (BC,H,Q)
    state = torch.einsum("bhqn,bhqp->bhnp", bf * state_w[..., None], xf)
    return y.to(x.dtype), state, cum


def ssd_chunked_ref(x, dt, a, b_mat, c_mat, d_skip, *, chunk: int,
                    initial_state=None, recurrence: str = "scan"):
    """``ops.ssd_chunked_cuda`` with :func:`ssd_intra_chunk_ref` as its
    intra-chunk step (same signature, same roundings)."""
    from repro_torch.kernels.ssd.ops import _ssd_chunked

    return _ssd_chunked(
        ssd_intra_chunk_ref, x, dt, a, b_mat, c_mat, d_skip, chunk=chunk,
        initial_state=initial_state, recurrence=recurrence,
    )
