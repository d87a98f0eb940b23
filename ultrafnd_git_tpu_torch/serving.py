"""Serving: score new records against an exported model directory.

Counterpart of `ultrafnd_git_tpu/serving.py`'s `Predictor` on its default
fused-align path, dense graph:

    predictor = Predictor(model_dir)          # device="cuda" by default
    rows = predictor.predict(records)         # [{id, prob_fake, label, ...}]

`model_dir` comes from `scripts/export_torch_model.py` (weights.pt,
meta.json, feature_cache.npz). A request is featurized on the host (hash
rungs), then one chunk runs the whole scoring program on the device:
temporal alignment, delay and aux, the text tower (its attention on the
flash kernel), the new-node GCN extension against the corpus graph,
fusion and the classifier. A new record attaches to the corpus by its
OCR-Jaccard row with self weight 2 / deg_new, exactly as a corpus node's
A_hat entry; new nodes do not see each other.

Not ported yet (each raises NotImplementedError; see ROADMAP.md): evidence
checkpoints, the sparse graph layout, bf16, int8 weights, multi-device
dispatch, explain() and the legacy two-dispatch path.
"""
from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ultrafnd_git_tpu.ops.hashing import set_hash_salt
from ultrafnd_git_tpu_torch.data.cache import load_cache
from ultrafnd_git_tpu_torch.data.featurize import featurize_records
from ultrafnd_git_tpu_torch.models.classifier import DeepTruthClassifier
from ultrafnd_git_tpu_torch.models.fusion import CrossModalTransformer
from ultrafnd_git_tpu_torch.models.gnn import SimpleGCN
from ultrafnd_git_tpu_torch.models.temporal import TemporalAlignMLP, _pad_or_trunc
from ultrafnd_git_tpu_torch.models.transformer import TextTransformer
from ultrafnd_git_tpu_torch.ops.graphctx import SLICES, build_graph_context
from ultrafnd_git_tpu_torch.utils.device import resolve_device

MAX_CHUNK_ROWS = 4096  # largest dispatch chunk on an accelerator
FORENSIC_KEYS = ("semantic_conflict", "temporal_delay", "emotion_intensity")


def _todo(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to ultrafnd_git_tpu_torch yet (see the "
        "port's module list in ROADMAP.md); serve it with ultrafnd_git_tpu"
    )


def build_modules(meta: Mapping[str, Any]) -> Dict[str, torch.nn.Module]:
    """The port's modules for a model directory's meta.json (no weights)."""
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


class Predictor:
    """Loads an exported model directory and scores FakeSV-style records."""

    def __init__(
        self,
        model_dir: str,
        batch_size: int = 64,
        device: str = "cuda",
        bf16: bool = False,
        quantize: bool = False,
        fused_align: bool = True,
        serve_dp: Optional[int] = None,
    ):
        for what, on in (
            ("bf16 serving", bf16),
            ("int8 (quantize) serving", quantize),
            ("the legacy two-dispatch path (fused_align=False)", not fused_align),
            ("multi-device dispatch (serve_dp)", serve_dp not in (None, 1)),
        ):
            if on:
                raise _todo(what)
        self.device = resolve_device(device)
        self.model_dir = Path(model_dir)
        self.batch_size = max(1, int(batch_size))
        with open(self.model_dir / "meta.json", "r", encoding="utf-8") as fh:
            self.meta = json.load(fh)
        cfg = self.meta["cfg"]
        if cfg.get("use_evidence", False):
            raise _todo("an evidence (use_evidence) checkpoint")
        self.use_gnn = bool(self.meta["fusion"]["use_gnn"])
        if cfg.get("sparse_graph", False) and self.use_gnn:
            raise _todo("the sparse graph layout (a --sparse_graph checkpoint)")

        # featurize under the hash draw the checkpoint was trained with;
        # the salt is process-wide, so featurize() sets it again per call
        self._hash_salt = str(cfg.get("hash_salt", ""))
        set_hash_salt(self._hash_salt)
        self._ocr_clean = cfg.get("ocr_phrase_pkl") is not None
        self.thresh = float(cfg.get("gnn_overlap_thresh", 0.12))
        self.cache = load_cache(str(self.model_dir / "feature_cache.npz"))

        weights = torch.load(
            self.model_dir / "weights.pt", map_location="cpu", weights_only=True
        )
        self.modules = build_modules(self.meta)
        for name, mod in self.modules.items():
            mod.load_state_dict(weights[name])
            mod.to(self.device).eval()
        self.align = self.modules["align"]
        self.fusion = self.modules["fusion"]
        self.clf = self.modules["clf"]
        self.gnn = self.modules.get("gnn")
        self.text_tower = self.modules.get("text_tower")

        if self.use_gnn:
            # corpus context once: the graph and layer-1 activations are
            # fixed at serving time
            gctx = build_graph_context(self.cache, self.thresh)
            self.XG = torch.from_numpy(gctx.xg).to(self.device)
            with torch.inference_mode():
                self.H_CORPUS = self.gnn.corpus_hidden(
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

    # ------------------------------------------------------------------
    def _new_node_rows(self, ocr_sets: Sequence[set]):
        """Normalised adjacency rows (B, N) of new nodes and self weights (B,)."""
        n = len(self._corpus_sizes)
        rows = np.zeros((len(ocr_sets), n), dtype=np.float32)
        for i, s in enumerate(ocr_sets):
            if not s:
                continue
            inter = np.zeros(n, dtype=np.float32)
            for tok in s:
                js = self._postings.get(tok)
                if js is not None:
                    inter[js] += 1.0
            union = len(s) + self._corpus_sizes - inter
            jac = inter / (union + 1e-9)
            rows[i] = (jac >= self.thresh).astype(np.float32)
        # a corpus node's A_hat self weight is 2 (adjacency diagonal plus
        # the added I); the new node mirrors it: deg = links + 2
        deg_new = rows.sum(axis=1) + 2.0
        self_w = (2.0 / deg_new).astype(np.float32)
        rows = rows / np.sqrt(deg_new)[:, None] / np.sqrt(self.corpus_deg)[None, :]
        return rows, self_w

    def featurize(
        self, records: Sequence[Dict[str, Any]], id_offset: int = 0
    ) -> Dict[str, Any]:
        """Host-only features of `records`, padded with empty records to a
        power-of-two bucket of at least 8 (rows past len(records) are
        never scored)."""
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
        )

    # ------------------------------------------------------------------
    def predict(self, records: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Score records; returns [{id, prob_fake, label, forensic...}].

        Chunk N+1 featurizes on a worker thread while the device scores
        chunk N. On the CPU a chunk is batch_size rows; on a GPU it grows
        along batch_size, 2x, 4x, ... up to MAX_CHUNK_ROWS.
        """
        if not records:
            return []
        records = list(records)
        n = len(records)
        max_rows = self.batch_size
        if self.device.type != "cpu":
            while max_rows * 2 <= MAX_CHUNK_ROWS:
                max_rows *= 2
        bounds = [(s, min(s + max_rows, n)) for s in range(0, n, max_rows)]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="featurize"
            )
        out: List[Dict[str, Any]] = []
        fut = self._pool.submit(self.featurize, records[bounds[0][0]:bounds[0][1]], 0)
        for ci, (s, e) in enumerate(bounds):
            feats = fut.result()
            if ci + 1 < len(bounds):
                ns, ne = bounds[ci + 1]
                fut = self._pool.submit(self.featurize, records[ns:ne], ns)
            out.extend(self._score_chunk(feats, e - s))
        return out

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

    def explain(self, *args, **kwargs):
        raise _todo("explain()")

    def close(self) -> None:
        """Stop the featurize worker thread."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # ------------------------------------------------------------------
    def _score_chunk(self, feats: Dict[str, Any], count: int) -> List[Dict[str, Any]]:
        """Score the first `count` rows of one featurized chunk in one pass."""
        bucket = self.batch_size
        while bucket < count:
            bucket *= 2
        pad = bucket - count

        def take(arr: np.ndarray, dtype=torch.float32) -> torch.Tensor:
            arr = np.asarray(arr[:count])
            if pad:  # pad the bucket by repeating the last row
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
            return torch.from_numpy(arr).to(self.device, dtype)

        with torch.inference_mode():
            t_raw = take(feats["text"])
            audio = take(feats["audio"])
            visual = take(feats["visual"])
            emo = take(feats["emo"])
            b = t_raw.shape[0]
            # align(T, V) and align(T, T) as one 2B-row pass
            both = self.align(
                torch.cat([t_raw, t_raw]),
                torch.cat([_pad_or_trunc(visual, t_raw.shape[1]), t_raw]),
            )
            u, u_tt = both[:b], both[b:]
            an = u_tt.norm(dim=-1) + 1e-9
            bn = u.norm(dim=-1) + 1e-9
            delay = (1.0 - (u_tt * u).sum(dim=-1) / (an * bn)).clamp(0.0, 1.0)
            aux = torch.stack([delay, emo], dim=1)
            model_in = {
                "audio_features": audio,
                "visual_features": visual,
                "temporal_features": u,
                "text_features": (
                    self.text_tower(
                        take(feats["text_ids"], torch.int64),
                        take(feats["text_mask"]),
                    )
                    if self.text_tower is not None
                    else t_raw
                ),
            }
            if self.use_gnn:
                by_key = {"text": t_raw, "audio": audio, "visual": visual, "temporal": u}
                xg_new = torch.cat([by_key[k][:, :w] for k, w in SLICES], dim=1)
                xg_new = xg_new / (xg_new.norm(dim=1, keepdim=True) + 1e-9)
                a_rows, self_w = self._new_node_rows(feats["ocr_sets"][:count])
                model_in["gnn_feat"] = self.gnn.extend(
                    take(a_rows), take(self_w), xg_new, self.XG, self.H_CORPUS
                )
            fo = self.fusion(model_in)
            probs = self.clf(fo["fused"], aux)["probs"]
            # one device -> host copy for everything the rows need
            host = torch.stack(
                [probs[:, 1]] + [fo["forensic"][k] for k in FORENSIC_KEYS]
            )[:, :count].cpu().numpy()
        return [
            {
                "id": str(feats["ids"][i]),
                "prob_fake": float(host[0, i]),
                "label": int(host[0, i] >= 0.5),
                **{k: float(host[1 + j, i]) for j, k in enumerate(FORENSIC_KEYS)},
            }
            for i in range(count)
        ]
