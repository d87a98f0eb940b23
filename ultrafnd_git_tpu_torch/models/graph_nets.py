"""Edge-list GNNs by segment sums (counterpart of
`ultrafnd_git_tpu/models/graph_nets.py`): `pad_edges`, GraphSAGE-mean
(`SAGELayer`, `PostEncoder`) and the posts / phrases / sources
`HeteroFGHGNN`.

Message passing is a segment sum over edge index arrays, `index_add_`
into one spare row past the real nodes. Edges padded to a fixed count by
`pad_edges` point at ghost ids (the sender or receiver count of their own
side) and carry nothing: the sender mean masks them, and the hetero
aggregation masks an edge whose sender or receiver is a ghost. Parameter
names follow the Flax tree (`self`, `nbr`; `sage{i}`, `sage_out`;
`embed_*`, `phr{i}`, `post{i}`, `out`), with `torch.nn.Linear` weights
(out, in), so `utils/transfer.graph_nets_state_dict` carries JAX params
across.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def pad_edges(
    senders: torch.Tensor,
    receivers: torch.Tensor,
    max_edges: int,
    num_nodes: int,
    num_receiver_nodes: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad edge lists to `max_edges`; padded edges point at ghost nodes
    (`num_nodes` for senders, `num_receiver_nodes`, default `num_nodes`, for
    receivers: hetero edges join node sets of different sizes). Returns
    (senders, receivers, valid mask)."""
    e = senders.shape[0]
    if e > max_edges:
        raise ValueError(f"edge count {e} exceeds max_edges {max_edges}")
    if num_receiver_nodes is None:
        num_receiver_nodes = num_nodes
    pad = max_edges - e
    mask = torch.cat([torch.ones(e, dtype=torch.bool), torch.zeros(pad, dtype=torch.bool)])
    s = torch.cat([senders, torch.full((pad,), num_nodes, dtype=senders.dtype)])
    r = torch.cat([receivers, torch.full((pad,), num_receiver_nodes, dtype=receivers.dtype)])
    return s, r, mask


def _segment_sum(values: torch.Tensor, segments: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum of `values` rows by segment id into (num_segments, ...) zeros."""
    out = values.new_zeros((num_segments, *values.shape[1:]))
    return out.index_add_(0, segments, values)


def _neighbor_mean(x: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor,
                   num_nodes: int) -> torch.Tensor:
    """Mean of sender features per receiver (the ghost slot dropped)."""
    msgs = x[senders.clamp(0, num_nodes - 1)]
    valid = (senders < num_nodes)[:, None].to(x.dtype)
    summed = _segment_sum(msgs * valid, receivers, num_nodes + 1)[:num_nodes]
    counts = _segment_sum(valid, receivers, num_nodes + 1)[:num_nodes]
    return summed / counts.clamp_min(1.0)


class SAGELayer(nn.Module):
    """GraphSAGE-mean: h' = act(W_self x + W_nbr mean_{j in N(i)} x_j)."""

    def __init__(self, in_dim: int, out_dim: int, act: bool = True):
        super().__init__()
        self.act = act
        self.self = nn.Linear(in_dim, out_dim)
        self.nbr = nn.Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor) -> torch.Tensor:
        nbr = _neighbor_mean(x, senders, receivers, x.shape[0])
        h = self.self(x) + self.nbr(nbr)
        return F.relu(h) if self.act else h


class PostEncoder(nn.Module):
    """Stacked SAGE layers over post-post edges -> (N, out_dim) embeddings."""

    def __init__(self, in_dim: int, hid: int = 128, out_dim: int = 128, layers: int = 2):
        super().__init__()
        dims = [in_dim] + [hid] * (layers - 1)
        self.n_hidden = layers - 1
        for i in range(self.n_hidden):  # the Flax names, sage0 ...
            self.add_module(f"sage{i}", SAGELayer(dims[i], hid))
        self.sage_out = SAGELayer(dims[-1], out_dim, act=False)

    def forward(self, x: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_hidden):
            h = getattr(self, f"sage{i}")(h, senders, receivers)
        return self.sage_out(h, senders, receivers)


def _typed_sum(x: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor,
               n_send: int, n_recv: int) -> torch.Tensor:
    """Masked typed aggregation: an edge whose sender (>= n_send) or
    receiver (>= n_recv) is a ghost contributes nothing."""
    valid = ((senders < n_send) & (receivers < n_recv))[:, None].to(x.dtype)
    msgs = x[senders.clamp(0, n_send - 1)] * valid
    return _segment_sum(msgs, receivers.clamp(0, n_recv), n_recv + 1)[:n_recv]


class HeteroFGHGNN(nn.Module):
    """Hetero message passing over posts / phrases / sources node sets.

    Edge types: (post -uses-> phrase) and its reverse, (source -publishes->
    post). Two rounds of typed aggregation; returns {"posts": the output
    embeddings, "phrases", "sources": their last hidden states}."""

    def __init__(self, dims: Dict[str, int], hid: int = 128, out_dim: int = 128,
                 rounds: int = 2):
        super().__init__()
        self.rounds = rounds
        self.embed_posts = nn.Linear(dims["posts"], hid)
        self.embed_phrases = nn.Linear(dims["phrases"], hid)
        self.embed_sources = nn.Linear(dims["sources"], hid)
        for i in range(rounds):  # the Flax names, phr0, post0 ...
            self.add_module(f"phr{i}", nn.Linear(2 * hid, hid))
            self.add_module(f"post{i}", nn.Linear(3 * hid, hid))
        self.out = nn.Linear(hid, out_dim)

    def forward(self, nodes: Dict[str, torch.Tensor],
                edges: Dict[str, Tuple[torch.Tensor, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        """nodes: {"posts": (P, D), "phrases": (H, D'), "sources": (S, D'')};
        edges: {"post_phrase": (post ids, phrase ids), "source_post":
        (source ids, post ids)}."""
        posts = self.embed_posts(nodes["posts"])
        phrases = self.embed_phrases(nodes["phrases"])
        sources = self.embed_sources(nodes["sources"])
        pp_s, pp_r = edges["post_phrase"]
        sp_s, sp_r = edges["source_post"]
        n_p, n_h, n_s = posts.shape[0], phrases.shape[0], sources.shape[0]
        for i in range(self.rounds):
            # phrases aggregate from the posts that use them
            phr_in = _typed_sum(posts, pp_s, pp_r, n_p, n_h)
            phrases = F.relu(getattr(self, f"phr{i}")(torch.cat([phrases, phr_in], -1)))
            # posts aggregate from their phrases and their source
            post_from_phr = _typed_sum(phrases, pp_r, pp_s, n_h, n_p)
            post_from_src = _typed_sum(sources, sp_s, sp_r, n_s, n_p)
            posts = F.relu(getattr(self, f"post{i}")(
                torch.cat([posts, post_from_phr, post_from_src], -1)))
        return {"posts": self.out(posts), "phrases": phrases, "sources": sources}
