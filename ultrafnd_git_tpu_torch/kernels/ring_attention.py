"""Ring attention: the sequence-parallel attention recurrence (counterpart
of `ultrafnd_git_tpu/kernels/ring_attention.py:41-89`).

The one position-mixing op of the sequence-sharded tower
(`parallel/sequence.py`): each rank of the sp group holds a local
(B, H, S/N, D) slice of Q, K and V and attends its Q block to every key by
passing its K, V and their padding bias around the ring
(`parallel/collectives.ppermute`, N - 1 hops; hop i sends to i + 1, so at
step t rank i holds the key block of rank (i - t) mod N) while the softmax
accumulates online: running max m (seeded at NEG_INIT), denominator l and
numerator acc, the flash recurrence. Every step runs in f32 whatever the
input dtype, in plain torch (einsum), as the JAX body runs `jnp.einsum`
outside any `pallas_call`: this is a module, not a port of a TPU kernel.
The (S, S) score matrix is never formed; a step forms (S/N, S/N) scores.

The step order is JAX's and is kept: on a row whose first key block is all
padding the running max starts at about -1e9, and only the later
correction exp(m - m_new) clears those keys, so another order rounds
otherwise. K, V and the bias ride one packed f32 buffer, one collective a
hop. Gradients flow through the recurrence and the hops (the ppermute's
backward is the inverse hop).
"""
from __future__ import annotations

import torch

from ultrafnd_git_tpu_torch.parallel.collectives import Shard, ppermute

NEG_INIT = -1e30  # running-max seed: finite so exp(m - new_m) is exact 0


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The local (B, H, S_loc, D) attention output of this rank's query
    block; q, k, v (B, H, S_loc, D) are this rank's slices and bias
    (B, 1, 1, S_loc) the additive padding bias of its key slice. Every rank
    of `shard` must call it. Returns q's dtype."""
    n = shard.size
    b, h, s_loc, d = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32, device=q.device))
    qf = q.float()
    kf, vf, bf = k.float(), v.float(), bias.float()
    m = torch.full((b, h, s_loc, 1), NEG_INIT, dtype=torch.float32, device=q.device)
    l = q.new_zeros((b, h, s_loc, 1), dtype=torch.float32)
    acc = q.new_zeros((b, h, s_loc, d), dtype=torch.float32)
    perm = [(i, (i + 1) % n) for i in range(n)]
    nk, nb = kf.numel(), bf.numel()
    for step in range(n):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale + bf
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vf)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        m = m_new
        if step < n - 1:  # n - 1 hops: a last one would only bring K/V home
            packed = ppermute(torch.cat([kf.reshape(-1), vf.reshape(-1), bf.reshape(-1)]),
                              shard, perm)
            kf = packed[:nk].view_as(kf)
            vf = packed[nk: 2 * nk].view_as(vf)
            bf = packed[2 * nk: 2 * nk + nb].view_as(bf)
    return (acc / l).to(q.dtype)
