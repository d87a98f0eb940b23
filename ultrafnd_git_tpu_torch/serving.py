"""Serving: score new records against an exported model directory.

Counterpart of `ultrafnd_git_tpu/serving.py`'s `Predictor` on its fused-align
path, everything it serves on one device:

    predictor = Predictor(model_dir)          # device="cuda" by default
    rows = predictor.predict(records)         # [{id, prob_fake, label, ...}]
    rows = predictor.explain(records, method="grad" | "shap")

`model_dir` comes from `scripts/export_torch_model.py` or the port's own
trainer (weights.pt, meta.json, feature_cache.npz). A request is
featurized on the host (hash rungs), then one chunk runs the whole scoring
program on the device: temporal alignment, delay and aux, the text tower
(its attention on the flash kernel), the new-node GCN extension against
the corpus graph, fusion and the classifier. A new record attaches to the
corpus by its OCR-Jaccard row with self weight 2 / deg_new, exactly as a
corpus node's A_hat entry; new nodes do not see each other, so scoring is
row-independent (the HTTP server's batching relies on it).

Levers, as the JAX Predictor's:
* `bf16=True`: tower, fusion and classifier built with dtype bf16 (their
  Dense layers, and the tower's attention on K2's bf16 mode); params stay
  f32; the align MLP and the GCN stay f32.
* `quantize=True`: every Dense and embedding matrix of at least 4096
  elements held as int8 with per-channel scales (`ops/quant.py`),
  dequantized right before use (to bf16 under bf16); the corpus GCN
  context comes from the f32 dequantization. explain() uses the
  full-precision modules.
* `sparse_graph`: the corpus graph as (N, K) neighbour lists (a
  `--sparse_graph` checkpoint's default; `sparse_graph=True/False`
  overrides it either way, the GCN params being layout-free); new nodes
  then attach through their (B, K) link lists instead of (B, N) rows.

An evidence checkpoint (`use_evidence`) is served as the JAX Predictor
serves it (`serving.py:525-527`): featurize adds the two host evidence
columns (semantic gap, emotion intensity) and the scoring program appends
the delay it computes, so the fusion gates read the (B, 3) scorer outputs;
explain() feeds the corpus rows' cached evidence to its background. Every
lever (bf16, int8, the sparse graph, the HTTP server) passes it through.

A switch-MoE tower (`moe_experts` in the meta's text_tower) is served as
the JAX Predictor serves it: the pooled output only, the router in f32
under bf16 (the experts in bf16), and under int8 the router's 2-D kernel
quantized with every other eligible matrix while the 3-D expert arrays
stay f32 (`quantize_tree`'s leaves). Its routing capacity depends on the
tokens of the call, so the chunk keeps the JAX bucket ladder: featurize
pads to a power of two >= 8 and `_score_chunk` to batch_size, 2x, 4x, ...
rows, by repeating the last row (padding rows are routed, as in JAX). The
capacity couples the rows of a chunk: where it drops a token, a record's
score depends on the records it is batched with, in JAX as here.

The device half of a chunk is one `ScoringProgram`, an `nn.Module` whose
forward takes tensors only: the Predictor featurizes, builds the new-node
rows, pads to the bucket and copies the results back once; the program
runs under `torch.inference_mode`. `export_serving.export_artifact`
freezes the same module with `torch.export` into an artifact directory
that `export_serving.ExportedPredictor` serves without a model directory.

`fused_align=False` is the JAX Predictor's legacy two-dispatch path:
featurize builds the full cache (`build_feature_cache(with_align=True)`),
its align pass on the Predictor's device with the module the fused
program runs, and the legacy program takes the cache's temporal, aux and
evidence. Whatever the default, a cache that carries "temporal" (a
persisted trainer cache, a legacy featurize) takes the legacy program and
a host-only one the fused program, as in JAX (`serving.py:566-576`).

Not ported yet (raises NotImplementedError; see ROADMAP.md): multi-device
dispatch (`serve_dp`).
"""
from __future__ import annotations

import copy
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ultrafnd_git_tpu_torch.data.cache import load_cache, make_encoders
from ultrafnd_git_tpu_torch.data.featurize import featurize_records
from ultrafnd_git_tpu_torch.models.classifier import DeepTruthClassifier
from ultrafnd_git_tpu_torch.models.fusion import CrossModalTransformer
from ultrafnd_git_tpu_torch.models.gnn import SimpleGCN, gather_sum
from ultrafnd_git_tpu_torch.models.temporal import (
    TemporalAlignMLP,
    TemporalSyncNet,
    _pad_or_trunc,
)
from ultrafnd_git_tpu_torch.models.transformer import TextTransformer
from ultrafnd_git_tpu_torch.ops.graphctx import (
    SLICES,
    build_graph_context,
    build_sparse_graph_context,
    compact_node_features,
)
from ultrafnd_git_tpu_torch.ops.hashing import set_hash_salt
from ultrafnd_git_tpu_torch.ops.quant import quantize_modules
from ultrafnd_git_tpu_torch.utils.device import resolve_device

MAX_CHUNK_ROWS = 4096  # largest dispatch chunk on an accelerator
FORENSIC_KEYS = ("semantic_conflict", "temporal_delay", "emotion_intensity")


def _todo(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to ultrafnd_git_tpu_torch yet (see the "
        "port's module list in ROADMAP.md); serve it with ultrafnd_git_tpu"
    )


def contract_keys(fused: bool, use_evidence: bool) -> List[str]:
    """The featurize() keys a scoring program of this contract reads (the
    host-only cache of the fused path, or the full cache of the legacy
    one), sorted."""
    if fused:
        return sorted(["audio", "emo", "text", "visual"] + ["evidence_host"] * use_evidence)
    return sorted(["audio", "aux", "temporal", "text", "visual"] + ["evidence"] * use_evidence)


def check_trainer_kind(kind: str) -> None:
    """Raise unless `kind` (a checkpoint meta's "trainer") is the v2
    trainer's, as the JAX Predictor does: the integrated trainer's GNNModel
    and the v2 SimpleGCN have the same parameter shapes at the default
    gnn_dim, so serving one as the other would give wrong scores silently."""
    if kind != "v2":
        raise ValueError(f"checkpoint was written by the '{kind}' trainer; "
                         "Predictor serves v2 checkpoints only")


def build_modules(
    meta: Mapping[str, Any], dtype: Optional[torch.dtype] = None
) -> Dict[str, torch.nn.Module]:
    """The port's modules for a model directory's meta.json (no weights);
    `dtype` is the compute dtype of the tower, fusion and classifier."""
    f, c, a = meta["fusion"], meta["classifier"], meta["align"]
    mods: Dict[str, torch.nn.Module] = {
        "align": TemporalAlignMLP(a["in_dim"], a["out_dim"]),
        "fusion": CrossModalTransformer(
            hidden=f["hidden"],
            text_dim=f["text_dim"],
            audio_dim=f["audio_dim"],
            visual_dim=f["visual_dim"],
            temporal_dim=f["temporal_dim"],
            use_gnn=f["use_gnn"],
            gnn_dim=f["gnn_dim"],
            dtype=dtype,
        ),
        "clf": DeepTruthClassifier(
            in_dim=f["hidden"],
            hidden=c["hidden"],
            num_classes=c["num_classes"],
            use_aux=c["use_aux"],
            aux_dim=c["aux_dim"],
            node_trees=c["node_trees"],
            node_depth=c["node_depth"],
            node_tau=c["node_tau"],
            temperature_init=c["temperature_init"],
            dtype=dtype,
        ),
    }
    if f["use_gnn"]:
        g = meta["gnn"]
        mods["gnn"] = SimpleGCN(g["in_dim"], g["hid"], g["out_dim"])
    t = meta.get("text_tower")
    if t:
        mods["text_tower"] = TextTransformer(
            width=t["width"],
            depth=t["depth"],
            heads=t["heads"],
            vocab_size=t["vocab_size"],
            max_len=t["max_len"],
            gelu=t["gelu"],
            dtype=dtype,
            moe_experts=int(t.get("moe_experts", 0)),
            moe_capacity_factor=float(t.get("moe_capacity_factor", 1.25)),
        )
    return mods


def write_seeded_model_dir(
    model_dir: str, meta: Mapping[str, Any], corpus: Mapping[str, Any], seed: int = 0
) -> Path:
    """A servable model directory with seeded random weights
    (`models.initializers.seeded_init_`, one torch.Generator) over the
    given corpus cache: for runs without a JAX checkpoint to export."""
    from ultrafnd_git_tpu_torch.data.cache import save_cache
    from ultrafnd_git_tpu_torch.models.initializers import seeded_init_
    from ultrafnd_git_tpu_torch.utils.transfer import write_model_dir

    gen = torch.Generator().manual_seed(seed)
    sds = {
        name: seeded_init_(mod, gen).state_dict()
        for name, mod in sorted(build_modules(meta).items())
    }
    root = write_model_dir(model_dir, sds, dict(meta))
    save_cache(dict(corpus), str(root / "feature_cache.npz"))
    return root


class ScoringProgram(nn.Module):
    """The device half of one request chunk: a dict of tensors in, tensors out.

    One module serves the live Predictor and the frozen artifact
    (`export_serving.py` runs it through `torch.export`), so both score
    with the same code. Every input carries the batch on its dim 0; the
    weights and the corpus context (`XG`, `H_CORPUS`) are its parameters
    and buffers. `forward` creates no tensor of its own, so the exported
    program runs on whichever device its weights are moved to.

    Two contracts, as the JAX Predictor's two scoring programs:
    * fused (`fused=True`, JAX `_make_score_fused`): the host-only
      features "text", "audio", "visual", "emo" and, for an evidence
      checkpoint, "evidence_host"; the program runs the align MLP (one
      2B-row pass), the delay, aux and the evidence delay column itself;
    * legacy (`fused=False`, JAX `_make_score(fused=False)`): a full
      feature cache's "audio", "visual", "temporal", "aux", "xg_new" (the
      compact node features, built on the host), "text" without a tower
      and "evidence" for an evidence checkpoint; the align pass ran in
      featurize.
    Both take "text_ids" / "text_mask" for a tower checkpoint and, with a
    GCN, "self_w" and the new nodes' links: "a_rows" (B, N) dense, or
    "link_idx" / "link_w" (B, K) with `sparse=True`. Returns (probs (B, 2),
    forensic (3, B) in FORENSIC_KEYS order, fused (B, hidden), aux (B, 2)).
    `forward` is `score` after `features`; the live Predictor calls the two
    stages itself, so that the host builds the new-node rows while the
    card runs stage one (the align pass and the tower).
    """

    def __init__(self, modules: Mapping[str, nn.Module], fused: bool, use_evidence: bool,
                 sparse: bool = False, xg: Optional[torch.Tensor] = None,
                 h_corpus: Optional[torch.Tensor] = None):
        super().__init__()
        self.fused, self.use_evidence, self.sparse = bool(fused), bool(use_evidence), bool(sparse)
        if self.fused:
            self.align = modules["align"]
        self.fusion = modules["fusion"]
        self.clf = modules["clf"]
        self.gnn = modules.get("gnn")
        self.text_tower = modules.get("text_tower")
        if self.gnn is not None:
            self.register_buffer("XG", xg)
            self.register_buffer("H_CORPUS", h_corpus)

    def features(self, x: Dict[str, torch.Tensor]):
        """Stage one, everything before the graph extension: (the fusion's
        inputs but the GCN's, aux, the new nodes' compact features or None)."""
        if self.fused:
            t_raw, visual = x["text"], x["visual"]
            b = t_raw.shape[0]
            # align(T, V) and align(T, T) as one 2B-row pass
            both = self.align(torch.cat([t_raw, t_raw]),
                              torch.cat([_pad_or_trunc(visual, t_raw.shape[1]), t_raw]))
            temporal, u_tt = both[:b], both[b:]
            an = u_tt.norm(dim=-1) + 1e-9
            bn = temporal.norm(dim=-1) + 1e-9
            delay = (1.0 - (u_tt * temporal).sum(dim=-1) / (an * bn)).clamp(0.0, 1.0)
            aux = torch.stack([delay, x["emo"]], dim=1)
        else:
            temporal, aux = x["temporal"], x["aux"]
        model_in = {
            "audio_features": x["audio"],
            "visual_features": x["visual"],
            "temporal_features": temporal,
            "text_features": (self.text_tower(x["text_ids"], x["text_mask"])
                              if self.text_tower is not None else x["text"]),
        }
        if self.use_evidence:
            # fused: [semantic gap, emotion intensity] from the host, the delay here
            model_in["evidence"] = (torch.cat([x["evidence_host"], delay[:, None]], dim=1)
                                    if self.fused else x["evidence"])
        xg_new = None
        if self.gnn is not None:
            if self.fused:
                by_key = {"text": x["text"], "audio": x["audio"], "visual": x["visual"],
                          "temporal": temporal}
                xg_new = torch.cat([by_key[k][:, :w] for k, w in SLICES], dim=1)
                xg_new = xg_new / (xg_new.norm(dim=1, keepdim=True) + 1e-9)
            else:
                xg_new = x["xg_new"]
        return model_in, aux, xg_new

    def score(self, model_in: Dict[str, torch.Tensor], aux: torch.Tensor,
              xg_new: Optional[torch.Tensor], x: Dict[str, torch.Tensor]):
        """Stage two, the graph extension (from the new nodes' links in `x`),
        fusion and classifier."""
        if self.gnn is not None:
            if self.sparse:
                gnn_feat = self.gnn.extend_sparse(
                    x["link_idx"], x["link_w"], x["self_w"], xg_new, self.XG, self.H_CORPUS)
            else:
                gnn_feat = self.gnn.extend(x["a_rows"], x["self_w"], xg_new, self.XG,
                                           self.H_CORPUS)
            model_in = {**model_in, "gnn_feat": gnn_feat}
        fo = self.fusion(model_in)
        probs = self.clf(fo["fused"], aux)["probs"]
        forensic = torch.stack([fo["forensic"][k] for k in FORENSIC_KEYS])
        return probs, forensic, fo["fused"], aux

    def forward(self, x: Dict[str, torch.Tensor]):
        return self.score(*self.features(x), x)


class Predictor:
    """Loads an exported model directory and scores FakeSV-style records."""

    # the scoring program exists at one batch shape (see export_serving):
    # _pipeline then never chunks past batch_size
    _fixed_shape_dispatch = False

    def __init__(
        self,
        model_dir: str,
        batch_size: int = 64,
        device: str = "cuda",
        bf16: bool = False,
        quantize: bool = False,
        fused_align: bool = True,
        serve_dp: Optional[int] = None,
        sparse_graph: Optional[bool] = None,
    ):
        if serve_dp not in (None, 1):
            raise _todo("multi-device dispatch (serve_dp)")
        self.device = resolve_device(device)
        self.model_dir = Path(model_dir)
        self.batch_size = max(1, int(batch_size))
        self.bf16, self.quantize = bool(bf16), bool(quantize)
        self.fused_align = bool(fused_align)
        with open(self.model_dir / "meta.json", "r", encoding="utf-8") as fh:
            self.meta = json.load(fh)
        check_trainer_kind(self.meta.get("trainer", "v2"))
        cfg = self.meta["cfg"]
        self.use_evidence = bool(cfg.get("use_evidence", False))
        self.use_gnn = bool(self.meta["fusion"]["use_gnn"])
        if sparse_graph is None:
            sparse_graph = bool(cfg.get("sparse_graph", False))
        self.sparse_graph = bool(sparse_graph)

        # featurize under the hash draw the checkpoint was trained with;
        # the salt is process-wide, so featurize() sets it again per call
        self._hash_salt = str(cfg.get("hash_salt", ""))
        set_hash_salt(self._hash_salt)
        self._ocr_clean = cfg.get("ocr_phrase_pkl") is not None
        self.thresh = float(cfg.get("gnn_overlap_thresh", 0.12))
        # the checkpoint was trained on exactly this cache: keep it across a
        # feature-code bump, as the JAX Predictor does
        self.cache = load_cache(str(self.model_dir / "feature_cache.npz"), stale_features="reuse")
        if self.cache is None:
            raise FileNotFoundError(f"no usable feature_cache.npz in {self.model_dir}")
        # the host encoders, built once (the scorers only for an evidence
        # checkpoint); their align MLP is unused: the scoring program runs
        # the checkpoint's own
        self._encoders = make_encoders(with_evidence=self.use_evidence, device="cpu")

        weights = torch.load(
            self.model_dir / "weights.pt", map_location="cpu", weights_only=True
        )
        # full-precision modules (explain() and its background read these)
        self.modules = build_modules(self.meta, torch.bfloat16 if self.bf16 else None)
        for name, mod in self.modules.items():
            mod.load_state_dict(weights[name])
            mod.to(self.device).eval()
        # the modules the scoring program runs: the same, or int8 copies
        self.score_modules = dict(self.modules)
        if self.quantize:
            dq = torch.bfloat16 if self.bf16 else torch.float32
            stats = {"quantized": 0, "kept": 0}
            for name in self.score_modules.keys() - {"align"}:  # align: never quantized
                self.score_modules[name] = copy.deepcopy(self.modules[name])
                for k, v in quantize_modules(self.score_modules[name], dq).items():
                    stats[k] += v
            print(f"int8 serving weights: {stats['quantized']} matrices quantized, "
                  f"{stats['kept']} small leaves kept f32", file=sys.stderr)
        self.align = self.score_modules["align"]
        self.fusion = self.score_modules["fusion"]
        self.clf = self.score_modules["clf"]
        self.gnn = self.score_modules.get("gnn")
        self.text_tower = self.score_modules.get("text_tower")
        if not self.fused_align:
            # the legacy featurize runs the align pass on this device, with
            # the module the fused program runs (one set of align weights)
            self._encoders["tsync"] = TemporalSyncNet.around(self.align)

        if self.use_gnn:
            # corpus context once: the graph and layer-1 activations are
            # fixed at serving time
            if self.sparse_graph:
                gctx = build_sparse_graph_context(self.cache, self.thresh)
                self.NBR_IDX = torch.from_numpy(gctx.nbr_idx).to(self.device, torch.int64)
                self.NBR_W = torch.from_numpy(gctx.nbr_w).to(self.device)
            else:
                gctx = build_graph_context(self.cache, self.thresh)
                self._a_norm = gctx.a_norm  # host copy, for explain()'s background
            self.XG = torch.from_numpy(gctx.xg).to(self.device)
            corpus_gnn = self.gnn
            if self.quantize and self.bf16:
                # the corpus context uses the f32 dequantization, the
                # requests the bf16 one (as the JAX Predictor)
                corpus_gnn = copy.deepcopy(self.modules["gnn"])
                quantize_modules(corpus_gnn, torch.float32)
            with torch.inference_mode():
                self.H_CORPUS = corpus_gnn.corpus_hidden(
                    torch.from_numpy(gctx.ax).to(self.device)
                )
            self.corpus_deg = gctx.deg
            # inverted index token -> corpus rows for new-node Jaccard rows
            postings: Dict[str, list] = {}
            for j, s in enumerate(self.cache["ocr_sets"]):
                for tok in s:
                    postings.setdefault(tok, []).append(j)
            self._postings = {
                tok: np.asarray(js, dtype=np.int64) for tok, js in postings.items()
            }
            self._corpus_sizes = np.asarray(
                [len(s) for s in self.cache["ocr_sets"]], dtype=np.float32
            )
        self._pool: Optional[ThreadPoolExecutor] = None
        self._explain_bg: Optional[np.ndarray] = None
        self._programs: Dict[bool, ScoringProgram] = {}

    def scoring_program(self, fused: bool, sparse: Optional[bool] = None) -> ScoringProgram:
        """A `ScoringProgram` over this Predictor's scoring modules and corpus
        context; `sparse` defaults to the Predictor's graph layout."""
        return ScoringProgram(
            self.score_modules, fused=fused, use_evidence=self.use_evidence,
            sparse=self.sparse_graph if sparse is None else sparse,
            xg=getattr(self, "XG", None), h_corpus=getattr(self, "H_CORPUS", None)).eval()

    def _program(self, fused: bool):
        """The program for a featurize contract: the Predictor's own one, or
        the other built at first use (a full cache handed to
        predict_featurized on a fused Predictor, or the reverse)."""
        if fused not in self._programs:
            self._programs[fused] = self.scoring_program(fused)
        return self._programs[fused]

    # ------------------------------------------------------------------
    def _new_node_links(self, ocr_sets: Sequence[set]) -> List[np.ndarray]:
        """Per new record, the corpus rows whose OCR Jaccard with it is at
        least the threshold (via the inverted index)."""
        n = len(self._corpus_sizes)
        links = []
        for s in ocr_sets:
            if not s:
                links.append(np.zeros(0, dtype=np.int64))
                continue
            inter = np.zeros(n, dtype=np.float32)
            for tok in s:
                js = self._postings.get(tok)
                if js is not None:
                    inter[js] += 1.0
            union = len(s) + self._corpus_sizes - inter
            links.append(np.flatnonzero(inter / (union + 1e-9) >= self.thresh))
        return links

    def _new_node_rows(self, ocr_sets: Sequence[set]):
        """Normalised adjacency rows (B, N) of new nodes and self weights (B,)."""
        links = self._new_node_links(ocr_sets)
        rows = np.zeros((len(links), len(self._corpus_sizes)), dtype=np.float32)
        for i, js in enumerate(links):
            rows[i, js] = 1.0
        # a corpus node's A_hat self weight is 2 (adjacency diagonal plus
        # the added I); the new node mirrors it: deg = links + 2
        deg_new = rows.sum(axis=1) + 2.0
        self_w = (2.0 / deg_new).astype(np.float32)
        rows = rows / np.sqrt(deg_new)[:, None] / np.sqrt(self.corpus_deg)[None, :]
        return rows, self_w

    def _new_node_lists(self, ocr_sets: Sequence[set]):
        """The same links as (B, K) neighbour lists: corpus ids (int64) and
        normalised weights (0 on padding slots), and self weights (B,)."""
        links = self._new_node_links(ocr_sets)
        k = max(1, max((len(js) for js in links), default=0))
        idx = np.zeros((len(links), k), dtype=np.int64)
        w = np.zeros((len(links), k), dtype=np.float32)
        deg_new = np.asarray([len(js) + 2.0 for js in links], dtype=np.float32)
        for i, js in enumerate(links):
            idx[i, :len(js)] = js
            w[i, :len(js)] = (np.float32(1.0) / np.sqrt(deg_new[i])
                              / np.sqrt(self.corpus_deg[js]))
        return idx, w, (2.0 / deg_new).astype(np.float32)

    def featurize(
        self, records: Sequence[Dict[str, Any]], id_offset: int = 0
    ) -> Dict[str, Any]:
        """Features of `records`, padded with empty records to a power-of-two
        bucket of at least 8 (rows past len(records) are never scored):
        host-only on the fused path; with fused_align=False the full cache,
        its align pass on the Predictor's device."""
        set_hash_salt(self._hash_salt)  # process-wide state, see __init__
        records = list(records)
        bucket = 8
        while bucket < len(records):
            bucket *= 2
        if records and bucket > len(records):
            records = records + [{}] * (bucket - len(records))
        return featurize_records(
            records,
            id_offset=id_offset,
            with_tower_tokens=self.text_tower is not None,
            ocr_clean=self._ocr_clean,
            with_evidence=self.use_evidence,
            encoders=self._encoders,
            with_align=not self.fused_align,
        )

    # ------------------------------------------------------------------
    def predict(self, records: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Score records; returns [{id, prob_fake, label, forensic...}].

        Chunk N+1 featurizes on a worker thread while the device scores
        chunk N. On the CPU a chunk is batch_size rows; on a GPU it grows
        along batch_size, 2x, 4x, ... up to MAX_CHUNK_ROWS.
        """
        return self._pipeline(records, collect_fused=False)[0]

    def predict_featurized(self, feats: Dict[str, Any], count: int) -> List[Dict[str, Any]]:
        """Score the first `count` rows of one featurize() output in one
        chunk: the scoring half that the HTTP batcher runs under its device
        lock while it featurizes the next window outside it. Rows equal
        predict()'s for a window that fits one chunk."""
        return self._score_chunk(feats, count)

    def _pipeline(self, records: Sequence[Dict[str, Any]], collect_fused: bool):
        """The featurize -> score loop behind predict() and explain():
        (rows, fused (n, H), aux (n, 2)); the last two are None unless
        collect_fused."""
        if not records:
            return [], None, None
        records = list(records)
        n = len(records)
        max_rows = self._max_chunk_rows()
        bounds = [(s, min(s + max_rows, n)) for s in range(0, n, max_rows)]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="featurize"
            )
        rows: List[Dict[str, Any]] = []
        fused_parts, aux_parts = [], []
        fut = self._pool.submit(self.featurize, records[bounds[0][0]:bounds[0][1]], 0)
        for ci, (s, e) in enumerate(bounds):
            feats = fut.result()
            if ci + 1 < len(bounds):
                ns, ne = bounds[ci + 1]
                fut = self._pool.submit(self.featurize, records[ns:ne], ns)
            out = self._score_chunk(feats, e - s, collect_fused)
            if collect_fused:
                out, f, a = out
                fused_parts.append(f)
                aux_parts.append(a)
            rows.extend(out)
        if collect_fused:
            return rows, np.concatenate(fused_parts), np.concatenate(aux_parts)
        return rows, None, None

    def _max_chunk_rows(self) -> int:
        """Rows of one dispatch chunk: batch_size on the CPU and for a
        program of one batch shape, else batch_size * 2^k <= MAX_CHUNK_ROWS."""
        rows = self.batch_size
        if self.device.type != "cpu" and not self._fixed_shape_dispatch:
            while rows * 2 <= MAX_CHUNK_ROWS:
                rows *= 2
        return rows

    def warmup(self, max_records: int = 64) -> int:
        """Run predict() once per bucket size up to the first power of two
        >= max_records (builds the kernel and warms the allocator before
        the first real request). Returns the number of sizes run."""
        sizes = [8]
        while sizes[-1] < int(max_records):
            sizes.append(sizes[-1] * 2)
        for n in sizes:
            self.predict([{"title": "warmup", "ocr": "", "comments": []}] * n)
        return len(sizes)

    def close(self) -> None:
        """Stop the featurize worker thread."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # ------------------------------------------------------------------
    def _bucket_take(self, count: int):
        """take(arr, dtype): the first `count` rows of a host array on the
        device, padded by repeating the last row to the bucket
        batch_size * 2^k >= count."""
        bucket = self.batch_size
        while bucket < count:
            bucket *= 2
        pad = bucket - count

        def take(arr, dtype=torch.float32) -> torch.Tensor:
            arr = np.asarray(arr[:count])
            if pad:
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
            return torch.from_numpy(arr).to(self.device, dtype)

        return take

    def _feature_inputs(self, feats: Dict[str, Any], count: int, fused: bool,
                        take) -> Dict[str, torch.Tensor]:
        """The program's inputs but the new nodes' links (the legacy
        contract's compact node features are built here, on the host)."""
        x = {k: take(feats[k]) for k in contract_keys(fused, self.use_evidence)}
        if self.text_tower is not None:
            x["text_ids"] = take(feats["text_ids"], torch.int64)
            x["text_mask"] = take(feats["text_mask"])
            if not fused:
                del x["text"]  # the tower computes the text features
        if self.use_gnn and not fused:
            x["xg_new"] = take(compact_node_features(
                {k: feats[k][:count] for k in ("text", "audio", "visual", "temporal")}))
        return x

    def _graph_inputs(self, feats: Dict[str, Any], count: int, sparse: bool,
                      take) -> Dict[str, torch.Tensor]:
        """The new nodes' links to the corpus: (B, N) rows, or (B, K) lists
        with `sparse`, and their self weights; {} without a GCN."""
        if not self.use_gnn:
            return {}
        ocr_sets = feats["ocr_sets"][:count]
        if sparse:
            idx, w, self_w = self._new_node_lists(ocr_sets)
            return {"link_idx": take(idx, torch.int64), "link_w": take(w), "self_w": take(self_w)}
        a_rows, self_w = self._new_node_rows(ocr_sets)
        return {"a_rows": take(a_rows), "self_w": take(self_w)}

    def program_inputs(self, feats: Dict[str, Any], count: int, fused: bool,
                       sparse: bool) -> Dict[str, torch.Tensor]:
        """Every input of the scoring program for the first `count` rows of
        a featurize() output, on the device and padded to the bucket."""
        take = self._bucket_take(count)
        return {**self._feature_inputs(feats, count, fused, take),
                **self._graph_inputs(feats, count, sparse, take)}

    def _run_program(self, feats: Dict[str, Any], count: int, fused: bool):
        """The program's outputs for one chunk. Its two stages are queued
        apart: the host builds the new-node rows while the card runs the
        first, whose inputs are all uploaded before (a pageable copy queued
        behind the tower would wait for it)."""
        program = self._program(fused)
        take = self._bucket_take(count)
        x = self._feature_inputs(feats, count, fused, take)
        stage = program.features(x)
        x.update(self._graph_inputs(feats, count, self.sparse_graph, take))
        return program.score(*stage, x)

    def _score_chunk(self, feats: Dict[str, Any], count: int, collect_fused: bool = False):
        """Score the first `count` rows of one featurized chunk in one pass;
        with collect_fused, (rows, fused (count, H), aux (count, 2)) numpy.
        A cache that carries "temporal" (a full feature cache: the legacy
        featurize, or a persisted trainer cache) takes the legacy program,
        a host-only one the fused program, whichever this Predictor's
        default."""
        with torch.inference_mode():
            probs, forensic, fused_rows, aux = self._run_program(
                feats, count, "temporal" not in feats)
            # one device -> host copy for everything the rows need
            host = torch.cat([probs[None, :, 1], forensic])[:, :count].cpu().numpy()
            if collect_fused:
                fused_np = fused_rows[:count].cpu().numpy()
                aux_np = aux[:count].cpu().numpy()
        rows = [
            {
                "id": str(feats["ids"][i]),
                "prob_fake": float(host[0, i]),
                "label": int(host[0, i] >= 0.5),
                **{k: float(host[1 + j, i]) for j, k in enumerate(FORENSIC_KEYS)},
            }
            for i in range(count)
        ]
        return (rows, fused_np, aux_np) if collect_fused else rows

    # ------------------------------------------------------------------
    def _explain_background(self, k: int) -> np.ndarray:
        """(K, hidden + 2) SHAP background from the training corpus: evenly
        spaced corpus rows through the full-precision fusion, with their
        transductive GCN embeddings and the tower's text features on tower
        checkpoints, beside their cached aux. Computed once, cached.
        Explaining a request against itself would make attributions depend
        on the rest of the request, and vanish for a single record."""
        if self._explain_bg is not None and self._explain_bg.shape[0] >= k:
            return self._explain_bg[:k]
        n = int(self.cache["labels"].shape[0])
        idx = np.unique(np.linspace(0, n - 1, num=min(k, n)).astype(np.int64))

        def rows(key, dtype=torch.float32):
            return torch.from_numpy(np.asarray(self.cache[key][idx])).to(self.device, dtype)

        m = self.modules
        with torch.inference_mode():
            feats = {
                "audio_features": rows("audio"),
                "visual_features": rows("visual"),
                "temporal_features": rows("temporal"),
                "text_features": (
                    m["text_tower"](rows("text_ids", torch.int64), rows("text_mask"))
                    if "text_tower" in m else rows("text")
                ),
            }
            if self.use_evidence:
                feats["evidence"] = rows("evidence")
            if self.use_gnn:
                if self.sparse_graph:
                    sel = torch.from_numpy(idx).to(self.device)
                    agg = gather_sum(self.NBR_IDX[sel], self.NBR_W[sel], self.H_CORPUS)
                else:
                    agg = torch.from_numpy(self._a_norm[idx]).to(self.device) @ self.H_CORPUS
                feats["gnn_feat"] = m["gnn"].lin2(agg)
            fused = m["fusion"](feats)["fused"].cpu().numpy()
        self._explain_bg = np.concatenate(
            [fused, self.cache["aux"][idx].astype(np.float32)], axis=1)
        return self._explain_bg

    def explain(
        self,
        records: Sequence[Dict[str, Any]],
        method: str = "grad",
        top_k: int = 8,
        n_coalitions: Optional[int] = None,
        background_size: int = 32,
    ) -> List[Dict[str, Any]]:
        """Score records and attach the classifier's attributions per record.

        Attributions are over the classifier's input, the fused embedding
        plus the two aux scalars [temporal_delay, emotion], with the
        full-precision modules. `method`:
          * "grad": Gradient x Input on the class-1 logit (one backward);
          * "shap": KernelSHAP of the class-1 probability against a fixed
            corpus background (`training/interpret.explain_shap`); for a
            "kernel-shap" result base_value + sum(values) == prob_fake (under
            quantize, the full-precision classifier's probability of the
            served fused row, as in the JAX Predictor).
        Each row gains "explain": {method, aux: {...}, top_fused_dims:
        [[dim, value], ...], fused_attr_l1, fused_signed_sum, and
        base_value for kernel-shap}.
        """
        from ultrafnd_git_tpu_torch.training import interpret

        if method not in ("grad", "shap"):
            raise ValueError(f"unknown explain method: {method!r}")
        if not records:
            return []
        rows, fused, aux = self._pipeline(list(records), collect_fused=True)
        clf = self.modules["clf"]
        base_values = None
        if method == "grad":
            values, _ = interpret.feature_importance(clf, fused, aux)
            method_used = "grad_x_input"
        else:
            out = interpret.explain_shap(
                clf, fused, aux, max_samples=len(rows), n_coalitions=n_coalitions,
                background=self._explain_background(background_size),
            )
            values, method_used = out["values"], out["method"]
            base_values = out.get("base_values")
        h = fused.shape[1]
        for i, row in enumerate(rows):
            v = np.asarray(values[i])
            fused_v, aux_v = v[:h], v[h:]
            order = np.argsort(-np.abs(fused_v))[: max(0, int(top_k))]
            info = {
                "method": method_used,
                "aux": {
                    "temporal_delay": float(aux_v[0]) if aux_v.size else 0.0,
                    "emotion": float(aux_v[1]) if aux_v.size > 1 else 0.0,
                },
                "top_fused_dims": [[int(d), float(fused_v[d])] for d in order],
                "fused_attr_l1": float(np.abs(fused_v).sum()),
                "fused_signed_sum": float(fused_v.sum()),
            }
            if base_values is not None:
                info["base_value"] = float(base_values[i])
            row["explain"] = info
        return rows
