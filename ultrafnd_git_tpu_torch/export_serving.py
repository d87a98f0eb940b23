"""Frozen scoring artifacts: the Predictor's scoring program through `torch.export`.

Counterpart of `ultrafnd_git_tpu/export_serving.py`.
`export_artifact(predictor, path)` freezes the `ScoringProgram` a live
`serving.Predictor` runs (align pass on the fused path, text tower with its
attention on the flash kernels' forward op, GCN extension, fusion,
classifier; int8 weights and their dequantization, or bf16 compute, as
the Predictor was built) into a directory of three files:

  scorer.pt2   `torch.export.save` of the program, traced once with one
               symbolic batch dimension shared by every per-request input,
               so one program serves every bucket; it holds the weights
               (f32, or int8 and scales) and the corpus context the graph
               extension reads (XG, H_CORPUS) as its parameters and buffers
  arrays.npz   the rest of the corpus context: the corpus degrees and OCR
               set sizes, the OCR posting lists as parallel (ocr_tok,
               ocr_doc) arrays, and, for a legacy-contract artifact, the
               align MLP its featurize runs (the fused program holds it)
  meta.json    the featurizer contract (hash salt, OCR tokenization, tower
               token length, evidence flag, Jaccard threshold, feature
               keys) under the format "ultrafnd-serving-artifact-torch/1"

`ExportedPredictor(path)` serves from that directory alone: no model
directory, no module construction; it imports `kernels.flash_attention`
(which registers the `ufnd::` ops the program calls) before
`torch.export.load`. It inherits the Predictor's featurize, chunking and
row building, so requests are handled as the live Predictor handles them.

The program creates no tensor of its own (`serving.ScoringProgram`), so
an artifact exported on the CPU serves on the card and the reverse;
`platforms` lists the device types it may be loaded on. The new nodes
always attach through dense (B, N) adjacency rows, as JAX's artifact does,
also for a `sparse_graph` Predictor: the corpus context is layout-free
once H_CORPUS is computed. A switch-MoE tower is refused: its routing
capacity is taken on the token count of the call (`models/moe.py`), which
a symbolic batch dimension cannot turn into a Python int, and JAX's
`jax.export` refuses the same program for the same reason.

    python -m ultrafnd_git_tpu_torch.export_serving --model_dir D --artifact A \
        [--bf16] [--quantize] [--batch_size 64] [--platforms cpu,cuda] [--device cuda]
    python -m ultrafnd_git_tpu_torch.predict --artifact A --input new.json
    python -m ultrafnd_git_tpu_torch.serve --artifact A --port 8080
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ultrafnd_git_tpu_torch.data.cache import TOWER_IDS_LEN, make_encoders
from ultrafnd_git_tpu_torch.models.temporal import TemporalSyncNet
from ultrafnd_git_tpu_torch.ops.hashing import set_hash_salt
from ultrafnd_git_tpu_torch.serving import Predictor, contract_keys
from ultrafnd_git_tpu_torch.utils.device import resolve_device

FORMAT = "ultrafnd-serving-artifact-torch/1"
JAX_FORMAT = "ultrafnd-serving-artifact/1"  # ultrafnd_git_tpu.export_serving's
FILES = ("scorer.pt2", "arrays.npz", "meta.json")
EXAMPLE_RECORDS = 5  # export traces one bucket of at least these rows (>= 2)


def export_artifact(
    predictor: Predictor, path: str, platforms: Sequence[str] = ("cpu", "cuda")
) -> Path:
    """Write the serving artifact of `predictor` (its levers, its fused or
    legacy contract) under `path`; returns the directory."""
    tower = predictor.text_tower
    if tower is not None and tower.moe_experts > 0:
        raise NotImplementedError(
            "a switch-MoE tower cannot be exported: its routing capacity, "
            "ceil(tokens * capacity_factor / experts), is a Python int of the "
            "token count, which a symbolic batch dimension does not have "
            "(ultrafnd_git_tpu.export_serving fails on it too); serve it with "
            "serving.Predictor")
    bad = sorted(set(platforms) - {"cpu", "cuda"})
    if bad or not platforms:
        raise ValueError(f"platforms must be among ('cpu', 'cuda'), got {list(platforms)}")
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    fused = predictor.fused_align
    program = predictor.scoring_program(fused, sparse=False)
    feats = predictor.featurize(
        [{"title": f"export {i}", "ocr": "", "comments": []} for i in range(EXAMPLE_RECORDS)])
    batch = torch.export.Dim("b", min=1)
    with torch.no_grad():
        x = predictor.program_inputs(feats, EXAMPLE_RECORDS, fused, sparse=False)
        ep = torch.export.export(program, (x,), dynamic_shapes=({k: {0: batch} for k in x},),
                                 strict=False)
    torch.export.save(ep, str(root / FILES[0]))

    arrays: Dict[str, np.ndarray] = {}
    if predictor.use_gnn:
        arrays["corpus_deg"] = np.asarray(predictor.corpus_deg, np.float32)
        arrays["corpus_sizes"] = np.asarray(predictor._corpus_sizes, np.float32)
        toks, docs = [], []
        for tok, js in predictor._postings.items():
            toks.extend([tok] * len(js))
            docs.extend(js.tolist())
        arrays["ocr_tok"] = np.asarray(toks, dtype=np.str_)
        arrays["ocr_doc"] = np.asarray(docs, dtype=np.int64)
    if not fused:
        for k, v in predictor.align.state_dict().items():
            arrays["align:" + k] = v.detach().cpu().numpy()
    np.savez_compressed(root / FILES[1], **arrays)

    cfg = predictor.meta["cfg"]
    meta = {
        "format": FORMAT,
        "platforms": list(platforms),
        "exported_on": predictor.device.type,
        "use_gnn": predictor.use_gnn,
        "use_evidence": predictor.use_evidence,
        "quantize": predictor.quantize,
        "bf16": predictor.bf16,
        "seed": int(cfg.get("seed", 42)),
        "hash_salt": predictor._hash_salt,
        "ocr_clean": predictor._ocr_clean,
        "thresh": predictor.thresh,
        "tower_len": int(tower.pos_embed.shape[1]) if tower is not None else None,
        "batch_size": predictor.batch_size,
        "n_corpus": int(predictor.cache["labels"].shape[0]),
        "fused_align": fused,
        "feats_keys": contract_keys(fused, predictor.use_evidence),
        "input_keys": sorted(x),
        "align": dict(predictor.meta["align"]),
    }
    (root / FILES[2]).write_text(json.dumps(meta, indent=1), encoding="utf-8")
    return root


class _ExportedTower:
    """Stands for the tower inside scorer.pt2: the inherited featurize()
    tokenizes for it when the Predictor has a text_tower."""

    def __repr__(self) -> str:
        return "<exported text tower (inside scorer.pt2)>"


class ExportedPredictor(Predictor):
    """Serve from an artifact directory written by `export_artifact`.

    Inherits the Predictor's featurize, chunking and row building; only the
    init (which reads the artifact alone) and the scoring program (the
    loaded one) differ. Chunks are capped at batch_size. explain() needs
    the full-precision modules and raises NotImplementedError, as JAX's.
    """

    _fixed_shape_dispatch = True

    def __init__(self, artifact_dir: str, batch_size: Optional[int] = None,
                 device: str = "cuda"):
        # Predictor.__init__ is not called: no model directory, no modules
        from ultrafnd_git_tpu_torch.kernels import flash_attention  # noqa: F401 (the ufnd:: ops)

        root = Path(artifact_dir)
        meta_path = root / FILES[2]
        if not meta_path.exists():
            raise FileNotFoundError(f"no serving artifact at {root} (missing {FILES[2]})")
        meta = json.loads(meta_path.read_text(encoding="utf-8"))
        fmt = meta.get("format")
        if fmt != FORMAT:
            hint = (" (an artifact of ultrafnd_git_tpu.export_serving: serve it with "
                    "that package, or export the model directory with this one)"
                    if fmt == JAX_FORMAT else "")
            raise ValueError(f"unsupported artifact format {fmt!r}: this build reads "
                             f"{FORMAT!r}{hint}")
        self.device = resolve_device(device)
        if self.device.type not in meta["platforms"]:
            raise ValueError(
                f"artifact was exported for {meta['platforms']} but this Predictor runs on "
                f"{self.device.type!r}: re-export with platforms=(..., "
                f"{self.device.type!r})")
        self.artifact_dir = root
        self.meta = meta
        self.batch_size = max(1, int(batch_size or meta["batch_size"]))
        self.bf16, self.quantize = bool(meta["bf16"]), bool(meta["quantize"])
        self.use_gnn, self.use_evidence = bool(meta["use_gnn"]), bool(meta["use_evidence"])
        self.fused_align = bool(meta["fused_align"])
        self.sparse_graph = False  # the artifact takes dense (B, N) rows
        self.thresh = float(meta["thresh"])
        self._hash_salt = str(meta["hash_salt"])
        self._ocr_clean = bool(meta["ocr_clean"])
        self.text_tower = _ExportedTower() if meta["tower_len"] is not None else None
        set_hash_salt(self._hash_salt)

        # the featurizer contract, checked now rather than at the first dispatch
        expected = contract_keys(self.fused_align, self.use_evidence)
        if expected != sorted(meta.get("feats_keys") or []):
            raise ValueError(
                f"artifact feature spec {sorted(meta.get('feats_keys') or [])} does not "
                f"match this build's featurizer output {expected}: re-export the artifact")
        if self.text_tower is not None and int(meta["tower_len"]) != TOWER_IDS_LEN:
            raise ValueError(
                f"artifact was exported with tower token length {meta['tower_len']} but "
                f"this build tokenizes to {TOWER_IDS_LEN}: re-export the artifact")

        with np.load(root / FILES[1], allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        if self.use_gnn:
            self.corpus_deg = arrays["corpus_deg"]
            self._corpus_sizes = arrays["corpus_sizes"]
            postings: Dict[str, list] = {}
            for tok, doc in zip(arrays["ocr_tok"].tolist(), arrays["ocr_doc"].tolist()):
                postings.setdefault(tok, []).append(doc)
            self._postings = {t: np.asarray(js, dtype=np.int64) for t, js in postings.items()}
        ep = torch.export.load(str(root / FILES[0]))
        if meta.get("exported_on") != self.device.type:
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, self.device)
        self._scorer = ep.module()
        self._encoders = make_encoders(with_evidence=self.use_evidence, device="cpu")
        if not self.fused_align:
            a = meta["align"]
            sd = {k[len("align:"):]: v for k, v in arrays.items() if k.startswith("align:")}
            self._encoders["tsync"] = TemporalSyncNet(
                a["in_dim"], a["out_dim"], state_dict=sd, device=str(self.device))
        self._pool = None

    def _run_program(self, feats, count: int, fused: bool):
        """The artifact's one program, of one contract, in one call."""
        if fused != self.fused_align:
            raise ValueError(
                f"this artifact was exported with fused_align={self.fused_align} but the "
                f"feature cache handed to predict_featurized follows the "
                f"{'fused' if fused else 'legacy'} contract: featurize with this "
                "ExportedPredictor's own featurize()")
        return self._scorer(self.program_inputs(feats, count, fused, sparse=False))

    def explain(self, *args, **kwargs):
        raise NotImplementedError(
            "explain() needs the full-precision modules; serve explanations from "
            "serving.Predictor(model_dir), not from an exported artifact")

    def _explain_background(self, *args, **kwargs):
        raise NotImplementedError("see explain()")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="ultrafnd_git_tpu_torch — export a frozen serving artifact")
    ap.add_argument("--model_dir", required=True,
                    help="exported model dir (scripts/export_torch_model.py, or the "
                         "trainer's --export_model_dir)")
    ap.add_argument("--artifact", required=True, help="directory to write the artifact into")
    ap.add_argument("--batch_size", type=int, default=64,
                    help="default serving chunk size recorded in the artifact "
                         "(loaders can override)")
    ap.add_argument("--platforms", default="cpu,cuda",
                    help="comma-separated device types the artifact may be loaded on")
    ap.add_argument("--bf16", action="store_true", help="export the bf16 scoring program")
    ap.add_argument("--quantize", action="store_true",
                    help="export int8 weights, dequantized in the program")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the Predictor runs while the program is traced")
    args = ap.parse_args(argv)
    platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip())
    predictor = Predictor(args.model_dir, batch_size=args.batch_size, device=args.device,
                          bf16=args.bf16, quantize=args.quantize)
    try:
        root = export_artifact(predictor, args.artifact, platforms=platforms)
    finally:
        predictor.close()
    sizes = {name: (root / name).stat().st_size for name in FILES}
    extras = sorted(p.name for p in root.iterdir() if p.name not in FILES)
    if extras:
        print(f"⚠️  target dir holds unrelated files (not artifact contents): {extras}")
    detail = ", ".join(f"{n} {s / 1e6:.2f} MB" for n, s in sizes.items())
    print(f"exported {root} ({sum(sizes.values()) / 1e6:.2f} MB: {detail}) "
          f"for platforms {list(platforms)}")


if __name__ == "__main__":
    main()
