#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: build, check and time its kernels, train
a full-width text-tower model through them (in f32 and under --bf16), then
serve the trained model on
every single-device lever (f32, bf16, int8), explain it, put it behind the
HTTP server, train and serve it again on the sparse graph layout, train a
switch-MoE tower (remat, a profile, a killed and resumed run) and serve it,
train an evidence model from a raw FakeSV data root through the CLI and
serve it, encode text through the text ladder's tower rung (seeded and
trained) and serve a training out_dir, search the hash salt over that
root, serve frozen scoring artifacts (torch.export) and the legacy
two-dispatch path, train with --trainer integrated, and run the v1
raw-media ensemble pipeline (decode, the device CV stage, the ensemble),
train on a mesh (--dp, --tp, then --sp, --pp, expert-parallel MoE) and
serve with serve_dp; the text, audio and evidence ladders' HF twins (BERT,
the DistilRoBERTa emotion classifier, wav2vec2, CLIP's text tower) run at
their published widths with seeded weights, and so does the text ladder's
language-model rung (LFM2-8B-A1B whole in bf16, K2-bf16's causal mode).

    python3 chip_smoke.py

Needs one CUDA GPU (an H100: the kernels are built for sm_90a) and nvcc.
Imports nothing of JAX. Phases, one line each; any failure exits non-zero:
  1. device  — nvidia-smi name and power limit, torch's device name, TF32 off;
  2. build   — nvcc builds every kernel from ultrafnd_git_tpu_torch/csrc, one
     process per source, all started together;
  3. kernels — each kernel against its plain PyTorch version on the card at
     the shapes the training and serving paths give it (plus ragged S and
     fully masked rows): K2 forward at atol = rtol 2e-5 and out within 1e-5
     of max|plain|, bit-identical over two calls; K2's bf16 mode at the
     serving buckets, D = 192, S = 100, 512 and 2048, out within 8e-3 of
     max|plain| and lse within 1e-4, bit-identical over two calls, and its
     dynamic shared memory at each width; the fused
     K3/K4 backward
     at atol = rtol 5e-4 and dq, dk, dv within 1e-5 of max|plain|,
     bit-identical over two calls; K3/K4's bf16 mode at the training shape
     and D = 64, 192, 256 x S = 64, 100, 512, dq, dk, dv and dbias within
     8e-3 of max|twin|, bit-identical over two calls; K1 (AdamW over the
     full-width parameter tree, 3 steps) bit for bit, no leaf on its scalar
     path. Each is timed
     (CUDA events around blocks of calls that start behind a
     torch.cuda._sleep lead, median of blocks) against its plain version
     and against one PyTorch library call that computes the same function
     (its yardstick, never called by the port): SDPA's memory-efficient f32
     kernels for K2 and for K3/K4's backward, SDPA with bf16 inputs and the
     same bias (the backend it picks, named) for K2's bf16 mode and, its
     backward, for K3/K4's (printed beside the f32 fused backward),
     torch._fused_adamw_ for K1;
     each gets its bound, the larger of its bytes over 3.35 TB/s and its
     operations over the peak rate of their type (H100 SXM data sheet):
     the flash kernels' products as the three TF32 products of 3xTF32 over
     495 TFLOP/s, K2-bf16's two and K3/K4-bf16's five bf16 products over
     989 TFLOP/s, K1's f32
     arithmetic over 67 TFLOP/s, computed from this
     run's shapes; K2 is also checked and timed at (512, 12, 256, 64), the
     seeded text rung's chunk. K1, K2's bf16 mode (its tensor maps are encoded on the
     host every call) and their library calls are also timed with the
     host's work included (no lead). K2 and its bf16 mode are swept over S
     and D (B * S = 16384); K2 at (128, 6, 64, 128) and K3/K4 in both
     modes at (256 and 128, 6, 64, 128), the pipelined tower's
     microbatches, checked and timed against their bound and SDPA; K1's
     yardstick also on the v1 ensemble's leaf table (phase v1_train);
     the ptxas report (registers, spills) of every kernel is printed;
 3b. hf_twins — the HF rungs' twins at the published widths of the
     checkpoints the ladders name, from constants (no config file, no
     transformers; weights drawn from a seed), whether or not transformers
     is importable (printed): K2 at (256, 12, 256, 64) with the padding
     bias and at (16, 12, 249, 64) with the zero bias against its plain
     version (atol = rtol 2e-5, out within 1e-5 of max|plain|, two calls
     bit for bit), timed against its bound and SDPA f32; then each twin's
     chunk through its entry point (`encode_ids` of bert-base-uncased and
     of CLIP ViT-B/32's text tower, 256 rows at S = 256 and 64;
     `predict_ids` of the DistilRoBERTa emotion classifier, 256 x 256;
     `encode_batch` of wav2vec2-base-960h, 16 waveforms of 80,000 samples)
     with the launches counted (K2 = layers a chunk, the BERT rung's chunks
     planned by length; CLIP 0), finite output of its shape (unit rows,
     probabilities summing to 1), within
     1e-4 of its largest value of the same module with the plain
     attention; the chunk's median wall ms over 5, its device ms by
     torch.profiler, K2's and the GEMMs' shares, the idle share;
  4. train   — ForensicTrainer on a synthetic corpus of N = 5376 at full
     width (tower 768 x 2 layers x 6 heads, S = 64, vocab 32768, fusion
     512, GCN 416-256-128, classifier 512 with a 6 x 4 NODE forest),
     --train_text_tower --fused_adamw, batch 512, f32: fit() for one epoch
     (8 steps over the 3763 training rows, then val) and test(); losses
     finite, launch counts K2 = depth x (steps + eval chunks), K3/K4 =
     depth x steps, K1 = steps; one gradient with dropout off on the GPU
     and on the CPU (plain versions) agree to 1e-4 of each leaf's largest;
 4b. bf16_train — the same under --bf16 (bf16_compute): launches K2 = K3/K4 =
     0, K2-bf16 = depth x (steps + eval chunks), K3/K4-bf16 = depth x steps,
     K1 = steps; the median step beside the f32 step, a profiled step; the
     GPU-vs-CPU gradient over one batch (512 rows) within 5e-2 in relative
     L2 and 1e-1 of each leaf's largest (the CPU test's bounds against the
     JAX bf16 step); the
     best slot exported and served once through Predictor(bf16=True);
  5. serve   — the trained `best` slot exported (align weights from the
     seeded model directory the cache came with) answers three predict()
     requests (8, 64, 300 records, each sent five times after a warm-up);
     K2 launches = depth x chunks; the CPU Predictor agrees within 1e-4; the
     device time of the 300-record request by kernel (torch.profiler);
  6. serve_levers — the same requests through Predictor(bf16), (quantize)
     and (bf16 + quantize): K2-bf16 launches = depth x chunks and f32 K2
     none under bf16, the reverse under quantize alone; each within 5e-2 of
     the f32 GPU rows with >= 90% of the labels, and within 2e-2 of its own
     CPU run (1e-4 for quantize alone); median latencies and the device
     time of the 300-record request;
  7. explain — explain() of 8 records by "grad" (within 1e-4 of the CPU
     Predictor's, of the largest attribution) and "shap" (kernel-shap rows
     whose base + sum equals prob_fake within 1e-5);
  8. http    — make_server on port 0 over the f32 GPU Predictor: 16 client
     threads (in a process of their own, stopped with the phase) each send
     8 one-record requests, then one 300-record request
     and one /explain; rows within 1e-5 of direct predict(), fewer
     dispatches than requests; p50 / p99 latency, records/s, records per
     dispatch;
  9. sparse  — phase 4 with --sparse_graph (the same launch counts, the
     GPU-vs-CPU gradient at 1e-4, the median step beside the dense one),
     then its model served through both graph layouts within 1e-5;
 10. raw_train — a synthetic FakeSV data root (data_complete.json, N = 5376
     records, 假 / 辟谣 balanced, Chinese titles, OCR and comments with
     emotion-lexicon terms, OCR topics that share tokens) trained through
     the training CLI's main() in this process: --data_root --use_evidence
     --train_text_tower, full width, batch 512, one epoch, seed 0,
     --export_model_dir. The cache is built there (host featurize, then
     the align pass on the card; both timed) and must equal a CPU build
     from the same seed: host columns exactly, temporal, aux[:, 0] and
     evidence[:, 2] within 1e-5 of their largest value (TF32 off); each
     evidence column varies; losses finite; launches K2 = depth x (steps
     + eval chunks), K3/K4 = depth x steps, K1 = steps + 2 (the GCN warm
     start's two updates run in the trainer's init, inside the CLI call);
     evidence statistics, the graph's edge count, the median step and the
     test metrics printed. A second main(--eval_only) on the same out_dir
     reuses the cache (printed, file untouched) and launches K2 = depth x
     test chunks and nothing else;
 10a. reference_migration — phase 4's run/best (a tower slot: its heads
     only, with the warning) exported to a reference best.pt through
     `export_reference`'s main(), imported through `import_reference`'s
     main() over phase 10's data root on its cache (copied in: the
     fingerprint matches, so it is reused, not rebuilt), served on the card
     at 8, 64 and 300 records within 1e-4 of the same slot on the CPU,
     fine-tuned one epoch by train --resume (from epoch 1; K1 = the
     import's and the resume's GCN warm starts, 2 each, + steps, nothing
     else launched; each of those K1 updates, on this model's leaf set of
     the heads alone, bit for bit against the plain update on a copy of
     its inputs, and the latest slot equal to the plain update's output of
     the last step), and its latest slot exported again: the file's
     tensors equal the slot's (the zero-filled semantic.* entries beside
     them);
 10b. text_tower — the text ladder's tower rung. Seeded
     (ULTRAFND_TEXT_DEVICE=1): the feature cache of phase 10's data root
     built on the card with its text column from the seeded tower (768
     wide, depth 4, 12 heads of 64, S = 256; chunks of 512 strings): K2
     launches = 4 x chunks and nothing else, the text pass's wall time, one
     profiled chunk (device ms, K2 and GEMM ms, idle share), the first 64
     records' text within 1e-5 of the largest value of a CPU build of the
     same draw. Trained (ULTRAFND_TEXT_DEVICE_CKPT = phase 10's out_dir):
     Predictor(out_dir=, checkpoint_name="latest") on the card answers
     three requests (8, 64, 300 raw records, five sends each after a
     warm-up): K2 launches = depth x (string chunks + 1) a send, rows within
     1e-4 of the CPU Predictor of the slot and the rung, latencies beside
     the hash rung's; Predictor(out_dir=, "best") within 1e-4 of the run's
     exported model directory;
 11. evidence_serve — the export answers three requests (8, 64, 300 raw
     records, each sent five times after a warm-up) and explain(grad) of 8
     on the card: K2 launches = depth x (15 + 1), rows within 1e-4 of the
     CPU Predictor, attributions within 1e-4 of the CPU's largest; median
     latencies, the host ms of the two evidence scorers alone on the 300
     records, the request's device time by kernel; the
     300-record request and its featurize in turns with the same weights
     served with use_evidence off;
 9b. moe_train — phase 4's model with --moe_experts 8 (switch top-1 FFN,
     capacity ceil(T * 1.25 / 8)), --remat_tower and --profile_dir, one
     epoch f32 and test(): losses finite, the trace names K2's and
     K3/K4's kernels, launches K2 = depth x (2 x steps + eval chunks) (the
     recompute runs K2 again), K3/K4 = depth x steps, K1 = steps; then
     steps with remat on and off in turns on the same trainer (median step,
     peak device memory by torch.cuda.max_memory_allocated), a profiled
     step, and the dropout-off gradient over 64 rows on the GPU against
     the CPU: zero tokens routed differently, each leaf within 1e-4 of its
     largest;
 9c. moe_serve — its best slot exported and served at 8, 64 and 300
     records in f32, bf16 and int8 (five sends each after a warm-up),
     explain(grad) of 8 in f32; each lever against its own CPU Predictor
     scoring each request as one chunk, as the card does (capacity
     depends on the tokens of the call): f32 and int8 within 1e-4 with
     zero tokens routed differently in f32, bf16 within 2e-2; launches by
     K2 mode;
 9d. moe_resume — the training CLI on that model with --save_every_steps 3
     in a process of its own, SIGKILLed right after its first mid-epoch
     slot commits; --resume then finishes the epoch in this process
     (launches: the 5 steps after the cursor only) and its latest slot
     (parameters, AdamW moments, step, dropout generator) equals an
     uninterrupted run's bit for bit;
 11b. auto_salt — the CLI with --auto_salt a on phase 10's data root
     (--use_evidence --train_text_tower, one epoch): two candidate runs,
     each building its cache; salt_search.json names the winner (the best
     validation AUC), the adopted out_dir exports (its align.pt came along)
     and serves 8 records on the card; launches of both runs and the
     winner's test;
 11c. artifact_serve — phase 5's model frozen by export_serving.export_artifact
     (torch.export of the scoring program, K2 as the ufnd:: op inside it) on
     the card in f32, bf16 and int8, each served by ExportedPredictor on the
     card: the three requests five times after a warm-up; K2 launches =
     depth x chunks of 64 rows (K2-bf16 under bf16, f32 K2 0): the kernel
     runs inside scorer.pt2; rows within 1e-6 of the live Predictor run on
     the same chunks (bit identity printed) and within 1e-4 (bf16 2e-2) of
     it on its own chunks; median latencies beside the live Predictor's;
     export seconds and file sizes; the device time of the 300-record
     request; then the model frozen on the CPU and served on the card,
     within 1e-4 of the CPU Predictor;
 11d. legacy_serve — Predictor(fused_align=False) on the card (the align pass in
     featurize, the legacy program) and the fused Predictor, the three
     requests in turns (five each, the order alternating): legacy rows
     within 1e-4 of the CPU legacy Predictor and 1e-5 of the fused GPU rows,
     K2 launches = depth x requests each; median latencies and featurize
     times of both;
 11e. integrated_train — the training CLI with --trainer integrated on phase 10's
     data root (N = 5376), batch 512, one epoch, then --eval_only (cache
     reused, no launch), in f32 and under --bf16: losses finite, best and
     latest slots tagged "integrated", K1 launches = steps and no flash
     kernel; the median step, samples/s and a profiled step's idle share;
     the dropout-off gradient of 512 rows on the card against the CPU from
     the same initial parameters (1e-4 of each leaf's largest; --bf16: the
     bf16 bounds of phase 4b);
 11f. v1_train — the v1 raw-media ensemble pipeline: (1) the device CV stage
     on 8 clips x 30 frames x 256^2 of 8-px blocks whose content moves
     (-4, +2) px a frame (host gray uploaded, as the path does): against
     its CPU run 0 block displacements flipped, flow_feat 1e-5, cuts 1e-6,
     flow_mags 1e-5 of their largest, bit-identical over two calls on the
     card and over two on the CPU (the reference), the median inner block
     flow within 0.3 px of the shift; its
     device ms, launches and upload bytes and ms (torch.profiler); (2)
     BatchFeatureExtractor.stream over 6 such batches, ms a sample in turns
     with the host cv2 ladder (stage, host, host, stage), a profiled
     batch's device and idle share, the host ms of ELA, spectral stats and
     text, one batch under ULTRAFND_TEXT_DEVICE=1 (K2 = 4 x string chunks);
     (3) EnsembleTrainer (E = 2, fusion 512, classifier.yaml) on those
     features, batch 8, 3 passes: K1 launches = steps and nothing else,
     the dropout-off gradient on the card against the CPU within 1e-4 of
     each leaf's largest + 1e-9, the median step, K1 on this path's leaf
     table and no-clip mode bit for bit against the plain update from the
     trained state, and K1 at this parameter count with its bound and plain
     version; (4) the CLI's main() on a copy
     of the fixture's 8 records with video (--epochs 2 --batch_size 4
     --eval_every 1, then --debug): loss finite, K1 = steps, every CV stage
     dispatch on the card, decode_failures printed; the phase's and the
     script's wall time;
 11g. mesh_train — the mesh layer on phase 4's model at full width (batch 512,
     N = 5376, one epoch = 8 steps, seed 0): (a) a world of one over NCCL,
     through the training CLI's main() in this process with --multihost
     --dp 1 --tp 1 --shard_corpus --shard_graph and a local coordinator
     (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES=1), against the same CLI
     without the mesh flags: the 8 step losses, the val and test losses and
     every parameter within 1e-6 relative (bit identity printed); launches
     K2 = depth x (steps + eval chunks), K3/K4 = depth x steps, K1 = steps +
     2; then steps of both trainers in turns (plain, mesh, mesh, plain):
     the median step of each, the collectives a step launches and each
     one's time between two synchronisations, and a profiled step of each:
     device ms, the NCCL kernels' ms, the idle share;
     (b) two ranks sharing the card over gloo (CUDA tensors reduced through
     the host), each a process of its own that joins the group itself and
     builds the trainer at --tp 2, then at --dp 2, 4 steps each, against
     4 steps of the plain trainer in this process: the losses within 1e-6
     of (a)'s first 4 and of the plain run's, the same on both ranks, the
     clip's global norm of each step, and the parameters and AdamW
     moments (the tp shards gathered) as whole trees, within 1e-6
     relative of the plain run's, each moment leaf within 1e-2 relative
     L2, and the replicated parameters bit-identical across the ranks
     (sha256); (a)'s NCCL group is destroyed before (b);
 11h. parallel_train — the rest of the mesh layer on the same model, cfg and
     plain run as mesh_train (b): two gloo ranks sharing the card, in one
     pair of processes, at --sp 2 (ring attention over the tower's
     sequence, plain torch), --pp 2 and --pp 2 --pp_microbatches 4 (GPipe
     over the tower's blocks, K2 and K3/K4 on each stage's microbatches),
     4 steps each, held to (b)'s bounds against the 4 plain steps (losses,
     clip norms, gathered parameters and AdamW moments; replicated
     parameters bit-identical); each rank's launches (K2 = K3/K4 = steps x
     microbatches x depth / pp under pp, 0 under sp; K1 = steps + 2); then a
     step with each all-reduce timed between two synchronisations and a
     profiled step (device ms, idle share, top kernels, the ms of the
     ring's forward kernels and, apart, of its copies); a MoE block
     (width 768, 8 experts, 32 x 64 tokens) with its experts cut over an
     ep group of the two ranks against the whole block (output, aux,
     input and parameter gradients within 1e-5 of their largest);
     serve_dp in this process: serve_dp=1 equal to the default Predictor,
     serve_dp = cards + 1 refused, and with two cards or more serve_dp =
     cards within 1e-6; the MoE export of phase 9c at serve_dp = cards
     (every bucket scored whole on replica 0) equal to its single
     Predictor's rows;
 12. a check that no module of jax or of the JAX package ultrafnd_git_tpu
     was loaded (server threads included), a JSON line of the kernels, then
     the JSON result line.
The train phase also prints the device time of one steady train step by
kernel (torch.profiler), the breakdown PERF.md keeps.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

T0 = time.perf_counter()
REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny"  # its 8 .avi clips with .wav sidecars

N_CORPUS = 5376  # FakeSV scale
OCR_VOCAB = 4096
TOKENS_PER_DOC = 12
REQUEST_SIZES = (8, 64, 300)  # 300 crosses the 256 bucket
REPEATS = 5  # each request is sent this many times; latency is the median
TOL = dict(atol=2e-5, rtol=2e-5)  # K2: both sides full-f32 matmuls (TF32 off)
BWD_TOL = dict(atol=5e-4, rtol=5e-4)  # K3/K4: the JAX suite's gradient tolerance
BWD_REL = 1e-5  # K3/K4 dq, dk, dv: max|kernel - plain| / max|plain| (3xTF32 ~ f32)
FWD_REL = 1e-5  # K2 out: max|kernel - plain| / max|plain| (3xTF32 ~ f32)
MEM_BPS = 3.35e12  # H100 SXM device memory, bytes/s (data sheet)
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores, FLOP/s (data sheet)
TF32_FLOPS = 495e12  # H100 SXM TF32 on the tensor cores, dense, FLOP/s (data sheet)
BF16_FLOPS = 989e12  # H100 SXM bf16 on the tensor cores, dense, FLOP/s (data sheet)
BF16_REL = 8e-3  # K2-bf16 out: max|kernel - plain| / max|plain| (one bf16 ulp at the top)
BF16_LSE = 1e-4  # K2-bf16 lse, atol = rtol
ADAMW_FLOP = 18  # f32 operations per parameter in csrc/adamw.cu's body (clipped step)
PROB_ATOL = 1e-4  # GPU vs CPU-plain, each served value
GRAD_RTOL = 1e-4  # GPU vs CPU-plain gradient, relative to each leaf's largest
# bf16_compute, GPU vs CPU-plain gradient: the CPU test's bounds against the
# JAX bf16 step (tests/test_torch_bf16_training.py): each leaf's relative L2
# error, and its largest error relative to its largest value; over one
# training batch of rows, not 64: the evidence gates' leaves difference two
# near-equal bf16 terms, and over 64 rows their rounding alone moved the
# GPU-vs-CPU gap to 5.9e-2 of a leaf's largest value (4.8e-2 in L2)
BF16_GRAD_L2 = 5e-2
BF16_GRAD_MAX = 1e-1
BWD_BF16_REL = 8e-3  # K3/K4-bf16 dq, dk, dv, dbias: max|kernel - twin| / max|twin|
TRAIN_BATCH = 512
SERVING_SHAPE = (256, 6, 64, 128)
TRAIN_SHAPE = (TRAIN_BATCH, 6, 64, 128)
TEXT_TOWER_SHAPE = (512, 12, 256, 64)  # the seeded text rung's K2 call: a chunk of 512 strings
# hf_twins: the HF rungs' published configurations (HF config field names), weights
# from a seed: bert-base-uncased; the DistilRoBERTa emotion classifier
# (j-hartmann/emotion-english-distilroberta-base, 7 labels); wav2vec2-base-960h;
# the text tower of openai/clip-vit-base-patch32 (eos_token_id 2: argmax pooling)
HF_BERT = dict(model_type="bert", vocab_size=30522, hidden_size=768, num_hidden_layers=12,
               num_attention_heads=12, intermediate_size=3072, max_position_embeddings=512,
               type_vocab_size=2, layer_norm_eps=1e-12)
HF_EMOTION = dict(model_type="roberta", vocab_size=50265, hidden_size=768, num_hidden_layers=6,
                  num_attention_heads=12, intermediate_size=3072, max_position_embeddings=514,
                  type_vocab_size=1, pad_token_id=1, layer_norm_eps=1e-5,
                  id2label={0: "anger", 1: "disgust", 2: "fear", 3: "joy", 4: "neutral",
                            5: "sadness", 6: "surprise"})
HF_W2V2 = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
               intermediate_size=3072, conv_dim=(512,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
               conv_stride=(5, 2, 2, 2, 2, 2, 2), conv_bias=False, num_conv_pos_embeddings=128,
               num_conv_pos_embedding_groups=16, layer_norm_eps=1e-5, do_stable_layer_norm=False,
               hidden_act="gelu", feat_extract_activation="gelu")
HF_CLIP = dict(vocab_size=49408, hidden_size=512, num_hidden_layers=12, num_attention_heads=8,
               intermediate_size=2048, max_position_embeddings=77, projection_dim=512,
               hidden_act="quick_gelu", layer_norm_eps=1e-5, eos_token_id=2)
HF_CHUNK, HF_SEQ = 256, 256  # BERT and RoBERTa: a chunk of 256 strings at S = 256
HF_WAVES, HF_SAMPLES = 16, 80000  # wav2vec2: 16 waveforms of 5 s at 16 kHz -> S = 249
HF_CLIP_SEQ = 64  # the semantic analyzer's max_length
HF_K2_SHAPES = ((HF_CHUNK, 12, HF_SEQ, 64), (HF_WAVES, 12, 249, 64))
HF_TWIN_REL = 1e-4  # a twin's output, K2 against the plain attention on the card (of its largest)
HF_TIMED = 5  # timed chunks a twin (after the main-path one)
CHECK_SHAPES = (
    SERVING_SHAPE,
    TEXT_TOWER_SHAPE,
    (64, 6, 64, 128),  # the bucket of the 8- and 64-record requests
    TRAIN_SHAPE,  # training batch; also the bucket of the 300-record request
    (8, 4, 64, 192),  # the test fixture's tower head width
    (4, 4, 100, 64),
    (4, 4, 512, 64),
    (2, 4, 2048, 64),
)
PP_SHAPES = ((TRAIN_BATCH // 2, 6, 64, 128),  # the pipelined tower's microbatch at --pp 2
             (TRAIN_BATCH // 4, 6, 64, 128))  # ... at --pp 2 --pp_microbatches 4
BWD_SHAPES = (
    TRAIN_SHAPE,
    (16, 6, 64, 128),  # the CLI's default batch
    (8, 4, 64, 192),
    (4, 4, 100, 64),
    (4, 4, 512, 64),
)
BF16_SHAPES = (
    (64, 6, 64, 128), SERVING_SHAPE, TRAIN_SHAPE,  # the serving buckets
    (8, 4, 64, 192),
    (4, 4, 100, 64),
    (4, 4, 512, 64),
    (2, 4, 2048, 64),
)
LEVERS = ({"bf16": True}, {"quantize": True}, {"bf16": True, "quantize": True})
LEVER_VS_F32 = 5e-2  # each lever's prob_fake against the f32 GPU rows
LEVER_LABELS = 0.9  # share of labels a lever keeps
LEVER_VS_CPU = 2e-2  # a bf16 lever's GPU rows against its own CPU run (1e-4 quantize alone)
HTTP_CLIENTS, HTTP_PER_CLIENT = 16, 8
SWEEP = ((128, 64), (128, 256), (128, 1024), (128, 2048), (64, 64), (64, 2048),
         (192, 512), (256, 512))  # (D, S) of K2's sweep
RAW_TOPICS = 128  # OCR topics of the raw data root (about 42 records each)
CACHE_REL = 1e-5  # card vs CPU cache build: align-derived columns, of their largest value
TOWER = dict(width=768, depth=2, heads=6, vocab_size=32768, max_len=64, gelu="tanh")
SEEDED_RUNG = dict(dim=768, depth=4, heads=12, max_len=256)  # ULTRAFND_TEXT_DEVICE=1's tower
TEXT_CHUNK = 512  # DeviceTextEncoder.encode_batch's strings a chunk
TEXT_CHECK_RECORDS = 64  # records of the seeded build held against a CPU build
MOE_EXPERTS = 8  # MoEFFN's default
MOE_SAVE_EVERY = 3  # moe_resume's --save_every_steps
MOE_REMAT_TURNS = 4  # steps each of remat on and off, in turns, after the fit
MOE_KILL_WORKER = """
import os, signal, sys
sys.path.insert(0, os.getcwd())
from ultrafnd_git_tpu_torch.train import main
from ultrafnd_git_tpu_torch.training import checkpoint as ckpt

save = ckpt.save_checkpoint

def save_then_die(directory, name, state, meta):
    save(directory, name, state, meta)
    if meta.get("in_epoch"):
        print("SIGKILL after the mid-epoch slot at step", meta["step_cursor"], flush=True)
        os.kill(os.getpid(), signal.SIGKILL)

ckpt.save_checkpoint = save_then_die
main(sys.argv[1:])
"""
MESH_REL = 1e-6  # mesh_train: a mesh vs the plain trainer, losses, norms and leaves (relative)
MESH_GLOO_TOL = 1e-6  # mesh_train (b): two gloo ranks' losses vs (a)'s and the plain run's
# mesh_train (b): each leaf of the AdamW moments, relative L2 to the plain run's. A
# gradient summed twice, or short of a rank's share, moves its leaf's mu by 50-100%;
# a leaf whose gradient is a cancelling sum (a forest threshold's, over 512 rows)
# rounds to ~6e-4 when tp or dp reorders that sum
MESH_LEAF_REL = 1e-2
MESH_GLOO_STEPS = 4
MESH_GLOO_LAYOUTS = (("tp2", {"tp": 2}), ("dp2", {"dp": 2}))
MESH_GLOO_WORKER = """
import hashlib, json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
from ultrafnd_git_tpu_torch.kernels.adamw import AdamW
from ultrafnd_git_tpu_torch.parallel import collectives as coll
from ultrafnd_git_tpu_torch.parallel.mesh import maybe_initialize_distributed, split_dim
from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer, TrainConfig

layout, cfg, steps = json.loads(sys.argv[1]), json.loads(sys.argv[2]), int(sys.argv[3])
if not maybe_initialize_distributed(backend="gloo"):
    raise SystemExit("no coordinator")
norms, scalars = [], AdamW.scalars

def recorded(self, grads, count):  # the clip's global norm of each step
    row = scalars(self, grads, count)
    norms.append(float(row[0]))
    return row

AdamW.scalars = recorded
t = ForensicTrainer(TrainConfig(**cfg, **layout), device="cuda")
losses, step_ms = [], []
for chunk, mask, _ in t.epoch_batches(t.tr_idx, True)[:steps]:
    torch.cuda.synchronize()
    s = time.perf_counter()
    loss = t.train_step(chunk, mask)[0].detach().clone()
    coll.all_reduce_(loss, t._data)  # the step's loss from every data rank's share
    torch.cuda.synchronize()
    step_ms.append(1e3 * (time.perf_counter() - s))
    losses.append(float(loss))
digest = hashlib.sha256()
for part, mod in sorted(t.state.params.items()):
    for name, p in sorted(mod.state_dict().items()):
        if split_dim(part, name) is None:
            digest.update(p.detach().cpu().numpy().tobytes())
full = t.state.state_dict()  # the tp shards gathered (collective)
torch.save({"params": full["params"], "mu": full["opt_state"]["mu"],
            "nu": full["opt_state"]["nu"]}, f"{cfg['out_dir']}/state.rank{t.mesh.rank}.pt")
print("RESULT " + json.dumps({"rank": t.mesh.rank, "coords": t.mesh.coords,
                              "backend": t.mesh.backend, "device": str(t.device),
                              "losses": losses, "norms": norms, "step_ms": step_ms,
                              "replicated_sha256": digest.hexdigest()}), flush=True)
torch.distributed.destroy_process_group()
"""
PARALLEL_STEPS = 4  # parallel_train: steps of each layout held against the plain run's
PARALLEL_LAYOUTS = (("sp2", {"sp": 2}), ("pp2", {"pp": 2}),
                    ("pp2_mb4", {"pp": 2, "pp_microbatches": 4}))
MOE_EP = dict(batch=32, seq=64, experts=MOE_EXPERTS)  # the ep check's MoE block, width 768
MOE_EP_REL = 1e-5  # ep-sharded block vs whole: output, aux, each gradient, of its largest value
PARALLEL_WORKER = """
import copy, hashlib, json, os, statistics, sys, time
sys.path.insert(0, os.getcwd())
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function
from ultrafnd_git_tpu_torch.kernels import adamw as aw, flash_attention as fa
from ultrafnd_git_tpu_torch.kernels.adamw import AdamW
from ultrafnd_git_tpu_torch.models import transformer as tr
from ultrafnd_git_tpu_torch.models.moe import EXPERT_LEAVES, MoEEncoderBlock, expert_parallel_
from ultrafnd_git_tpu_torch.parallel import collectives as coll
from ultrafnd_git_tpu_torch.parallel import mesh as meshlib
from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer, TrainConfig

layouts, cfg, steps, moe = (json.loads(a) for a in sys.argv[1:5])
if not meshlib.maybe_initialize_distributed(backend="gloo"):
    raise SystemExit("no coordinator")
rank = dist.get_rank()
ring = tr.ring_attention_local

def ring_marked(*a, **kw):  # the ring's forward, as one range of the profile
    with record_function("ring_attention"):
        return ring(*a, **kw)

tr.ring_attention_local = ring_marked
norms, scalars = [], AdamW.scalars

def recorded(self, grads, count):  # the clip's global norm of each step
    row = scalars(self, grads, count)
    norms.append(float(row[0]))
    return row

def counts():
    return {"fwd": fa.launches, "fwd_bf16": fa.bf16_launches, "bwd": fa.bwd_launches,
            "bwd_bf16": fa.bwd_bf16_launches, "adamw": aw.launches}

AdamW.scalars = recorded
for name, layout in layouts:
    before, norms[:] = counts(), []
    out_dir = f"{cfg['out_dir']}/{name}"
    t = ForensicTrainer(TrainConfig(**{**cfg, "out_dir": out_dir}, **layout), device="cuda")
    batches = t.epoch_batches(t.tr_idx, True)
    losses, step_ms, calls = [], [], []

    def step(i):
        chunk, mask, _ = batches[i % len(batches)]
        torch.cuda.synchronize()
        c, s = coll.calls, time.perf_counter()
        loss = t.train_step(chunk, mask)[0].detach().clone()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - s))
        calls.append(coll.calls - c)
        return loss

    for i in range(steps):
        loss = step(i)
        coll.all_reduce_(loss, t._data)  # the step's loss from every data rank's share
        losses.append(float(loss))
    digest = hashlib.sha256()
    for part, mod in sorted(t.state.params.items()):
        for key, p in sorted(mod.state_dict().items()):
            if meshlib.split_dim(part, key) is None:
                digest.update(p.detach().cpu().numpy().tobytes())
    full = t.state.state_dict()
    torch.save({"params": full["params"], "mu": full["opt_state"]["mu"],
                "nu": full["opt_state"]["nu"]}, f"{out_dir}/state.rank{rank}.pt")
    step_norms = list(norms)
    # the collectives' own time in one more step: each between two synchronisations
    all_reduce, spent = dist.all_reduce, []

    def timed_all_reduce(*a, **kw):
        torch.cuda.synchronize()
        s = time.perf_counter()
        r = all_reduce(*a, **kw)
        torch.cuda.synchronize()
        spent.append(1e3 * (time.perf_counter() - s))
        return r

    dist.all_reduce = timed_all_reduce
    try:
        step(steps)
    finally:
        dist.all_reduce = all_reduce
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(steps + 1)
    events = prof.key_averages()
    # device work only: a range's GPU-side annotation (the ring's, gloo's)
    # spans the idle time between its first and last kernel
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.key != "ring_attention" and not e.key.startswith("gloo:")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # the device work launched inside the ring's CPU-side ranges: its own
    # kernels, and apart the copies (its hops' device-host copies for gloo)
    ring_us = {"kernels": 0.0, "copies": 0.0}

    def launched(e):
        yield from e.kernels
        for c in e.cpu_children:
            yield from launched(c)

    for e in prof.events():
        if e.name == "ring_attention" and e.device_type == DeviceType.CPU:
            for k in launched(e):
                ring_us["copies" if k.name.startswith(("Memcpy", "Memset")) else "kernels"] \
                    += k.duration
    median = statistics.median(step_ms[1:steps])
    print(f"RESULT {name} " + json.dumps({
        "rank": rank, "coords": t.mesh.coords, "backend": t.mesh.backend,
        "device": str(t.device), "losses": losses, "norms": step_norms,
        "step_ms": step_ms[:steps], "median_step_ms": median,
        "collectives_a_step": calls[0], "collective_ms": spent,
        "profiled_step_ms": step_ms[-1], "step_device_ms": device_ms,
        "idle_share": max(0.0, 1.0 - device_ms / median),
        "ring_forward_kernel_ms": ring_us["kernels"] / 1e3,
        "ring_forward_copy_ms": ring_us["copies"] / 1e3,
        "top_kernels": [[e.key[:60], e.count, e.self_device_time_total / 1e3] for e in
                        sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]],
        "replicated_sha256": digest.hexdigest(), "steps_run": len(step_ms),
        "launches": {k: v - before[k] for k, v in counts().items()}}), flush=True)
    del t, full
    torch.cuda.empty_cache()
AdamW.scalars = scalars

# the MoE block with its experts cut over an ep group of the two ranks
before = counts()
mesh = meshlib.make_mesh(extra_axes=[("ep", 2)])
gen = torch.Generator().manual_seed(0)
whole = MoEEncoderBlock(768, 6, num_experts=moe["experts"])
with torch.no_grad():
    for p in whole.parameters():
        p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
whole = whole.cuda()
x0 = torch.randn(moe["batch"], moe["seq"], 768, generator=gen).cuda()
probe = torch.randn(moe["batch"], moe["seq"], 768, generator=gen).cuda()
lengths = torch.randint(1, moe["seq"] + 1, (moe["batch"],), generator=gen)
mask = (torch.arange(moe["seq"])[None] < lengths[:, None]).float().cuda()
sharded = expert_parallel_(copy.deepcopy(whole), mesh.shard("ep"))
res = {}
for tag, block in (("whole", whole), ("ep", sharded)):
    x = x0.clone().requires_grad_()
    torch.cuda.synchronize()
    c, s = coll.calls, time.perf_counter()
    y, aux = block(x, mask)
    ((y * probe).sum() + aux).backward()
    torch.cuda.synchronize()
    res[tag] = (y.detach(), aux.detach(), x.grad, {k: p.grad for k, p in block.named_parameters()},
                1e3 * (time.perf_counter() - s), coll.calls - c)

def rel(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)

i, per = mesh.shard("ep").rank, moe["experts"] // 2
grad_rel = max(rel(g, res["whole"][3][k][i * per: (i + 1) * per]
                   if k.rsplit(".", 1)[-1] in EXPERT_LEAVES else res["whole"][3][k])
               for k, g in res["ep"][3].items())
print("MOE " + json.dumps({
    "rank": rank, "y_rel": rel(res["ep"][0], res["whole"][0]),
    "aux_rel": rel(res["ep"][1], res["whole"][1]), "dx_rel": rel(res["ep"][2], res["whole"][2]),
    "grad_rel": grad_rel, "ms": res["ep"][4], "whole_ms": res["whole"][4],
    "collectives": res["ep"][5],
    "expert_shapes": [tuple(getattr(sharded.moe, k).shape) for k in EXPERT_LEAVES],
    "launches": {k: v - before[k] for k, v in counts().items()}}), flush=True)
dist.destroy_process_group()
"""
KERNELS = ("flash_attention_fwd", "flash_attention_fwd_bf16", "flash_attention_bwd",
           "flash_attention_bwd_bf16", "adamw", "gemm_tf32x3")
V1_BATCH, V1_FRAMES = 8, 30  # the v1 collate's clips: (B, 30, 256, 256, 3) uint8
V1_SHIFT = (-4, 2)  # (dy, dx) px a frame the v1_train clips' content moves
V1_STREAM_BATCHES = 6  # batches of the feature stage's timed stream
V1_EPOCHS = 3  # passes of the ensemble over those batches' features
CV_FEAT_ATOL, CV_CUTS_ATOL, CV_MAGS_REL = 1e-5, 1e-6, 1e-5  # CV stage, card vs CPU
V1_GRAD_FLOOR = 1e-9  # f32 floor of the v1 gradient check (tests/test_torch_pipeline_v1.py)
BWD_BF16_SHAPES = (TRAIN_SHAPE,) + tuple((4, 4, s, d) for d in (64, 192, 256) for s in (64, 100, 512))
CJK_WORDS = ("外星人", "入侵", "地球", "警告", "辟谣", "谣言", "不实", "疫苗",
             "危险", "致命", "隐瞒", "专家", "证据", "科学", "视频", "记录")


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a GPU")
    from ultrafnd_git_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", torch_name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
        tf32=torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
    return dev


def _kernel_label(symbol: str) -> str:
    """`name<D>` of a mangled kernel symbol (its length-prefixed identifier
    that ends in "kernel", and its int template argument)."""
    i = 0
    while i < len(symbol):
        m = re.match(r"\d+", symbol[i:])
        if not m:
            i += 1
            continue
        start = i + m.end()
        i = start + int(m.group())
        if symbol[start:i].endswith("kernel"):
            arg = re.match(r"ILi(\d+)E", symbol[i:])
            return symbol[start:i] + (f"<{arg.group(1)}>" if arg else "")
    return symbol


def phase_build():
    from ultrafnd_git_tpu_torch.kernels import _build, adamw as aw, flash_attention as fa
    from ultrafnd_git_tpu_torch.kernels import gemm_tf32x3 as gk

    def timed(name):
        t0 = time.perf_counter()
        _build.build(name)  # nvcc -> build/torch_kernels, keyed by the source
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        seconds = dict(zip(KERNELS, pool.map(timed, KERNELS)))
    fa._kernel(), fa._bf16_kernel(), fa._bwd_kernel(), fa._bwd_bf16_kernel(), aw._kernel()
    gk._kernel()
    ptxas = {}
    for name, s in seconds.items():
        log("build", kernel=name, seconds=s,
            lib=_build.library_path(name).relative_to(REPO))
        for symbol, info in _build.ptxas_report(name).items():
            label = _kernel_label(symbol)
            ptxas.setdefault(name, {})[label] = info
            log("build", ptxas=label, **info)
    return ptxas


def _attention_inputs(shape, seed, dev):
    import torch

    b, h, s, d = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g).to(dev) for _ in range(4))
    lengths = torch.randint(0, s + 1, (b,), generator=g)
    lengths[0] = 0  # a fully masked row (an empty or padded record)
    if b > 1:
        lengths[1] = s
    mask = (torch.arange(s)[None] < lengths[:, None]).float().to(dev)
    return q, k, v, do, mask


def _median_ms(fn, runs=30, calls=10, warmup=5, before_block=None, lead=True):
    """Median over `runs` of the per-call time of `calls` back-to-back calls.

    CUDA events around each block time device work, not Python dispatch:
    each block starts behind a `torch.cuda._sleep` lead, so the host has
    enqueued the whole block before the device reaches its first call. A
    block whose start event had already completed when the enqueue ended
    is run again with the lead doubled. `lead=False` times without it, for
    a call of more launches than CUDA queues ahead (the launches then wait
    for the device, so no lead can cover them): its time is then the host's
    dispatch wherever that is the slower. `before_block` (not timed) runs
    before each block."""
    import torch

    for _ in range(warmup):
        fn()
    cycles = 1 << 20  # about 0.6 ms on an H100
    times = []
    while len(times) < runs:
        if before_block is not None:
            before_block()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if lead:
            torch.cuda._sleep(cycles)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        started = lead and e0.query()  # the device reached the block before its enqueue ended
        e1.synchronize()
        if started:
            cycles *= 2
            if cycles > 1 << 32:
                raise RuntimeError(f"a lead of {cycles >> 1} cycles did not cover the enqueue")
            continue
        times.append(e0.elapsed_time(e1) / calls)
    return statistics.median(times)


def _unaligned_leaves(leaves) -> int:
    """K1's (p, m, v, g) leaves with a pointer not 16-byte aligned: those its
    scalar path takes."""
    return sum(any(t.data_ptr() % 16 for t in leaf) for leaf in leaves)


def _max_err(a, b) -> float:
    return (a - b).abs().max().item()


def _bound(nbytes: float, flop: float, peak: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over `peak`, the rate of their type, whichever is larger."""
    t_bytes, t_ops = nbytes / MEM_BPS, flop / peak
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flop": flop, "peak_flops": peak}


def _fwd_bound(shape) -> dict:
    b, h, s, d = shape  # q, k, v, bias in; out, lse out; Q K^T and P V in 3xTF32
    return _bound(4 * (4 * b * h * s * d + b * s + b * h * s), 3 * 4 * b * h * s * s * d,
                  TF32_FLOPS)


def _bwd_bound(shape) -> dict:
    b, h, s, d = shape  # q, k, v, out, dO, lse, bias in; dq, dk, dv out; 5 products, 3xTF32
    return _bound(4 * (8 * b * h * s * d + b * h * s + b * s), 3 * 10 * b * h * s * s * d,
                  TF32_FLOPS)


def _sdpa(q, k, v, bias):
    """The library yardstick of K2: SDPA in f32 on its memory-efficient
    kernel (flash and cuDNN SDPA take no f32)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias)


GEMM_PRODUCTS = (("qkv", 2304, 768, False), ("attn_out", 768, 768, False),
                 ("ffn_in", 3072, 768, True), ("ffn_out", 768, 3072, False))
GEMM_ROWS = (16384, 2048)  # an ocr chunk (64 x 256); a fields chunk of 8 x 256


def check_gemm_tf32x3(dev):
    """The BERT rung's 3xTF32 GEMM at bert-base's four products, at an ocr
    chunk's M and a small one: against the f64 product beside cuBLAS f32,
    against its plain version, timed against its bound (the work counted
    once: 2 M N K at 495 TFLOP/s, or X, W, b and Y once at 3.35 TB/s; and
    the 3xTF32 charge, three TF32 passes), the plain version and F.linear
    (cuBLAS f32; F.gelu after it for the intermediate) as `library_ms`."""
    import torch
    import torch.nn.functional as F

    from ultrafnd_git_tpu_torch.kernels import gemm_tf32x3 as gk

    rows, t0, before = [], time.perf_counter(), gk.launches
    with torch.inference_mode():
        for m in GEMM_ROWS:
            for i, (name, n, k, gelu) in enumerate(GEMM_PRODUCTS):
                g = torch.Generator().manual_seed(900 + i)
                x = torch.randn(m, k, generator=g).to(dev)
                w = (0.02 * torch.randn(n, k, generator=g)).to(dev)
                b = (0.02 * torch.randn(n, generator=g)).to(dev)
                hi, lo = gk.split_tf32(w)

                def lib():
                    y = F.linear(x, w, b)
                    return F.gelu(y) if gelu else y

                y, y2, plain, ref = (gk.linear_tf32x3(x, hi, lo, b, gelu),
                                     gk.linear_tf32x3(x, hi, lo, b, gelu),
                                     gk.reference_linear(x, hi, lo, b, gelu), lib())
                want = F.linear(x.double(), w.double(), b.double())
                want = F.gelu(want) if gelu else want
                torch.cuda.synchronize()
                scale = want.abs().max().item()
                gap = (y.double() - want).abs().max().item() / scale
                lib_gap = (ref.double() - want).abs().max().item() / scale
                plain_rel = _max_err(y, plain) / plain.abs().max().item()
                if not torch.equal(y, y2):
                    raise RuntimeError(f"gemm_tf32x3 {name} at M = {m}: two calls differ")
                if not gap <= 2 * lib_gap:
                    raise RuntimeError(f"gemm_tf32x3 {name} at M = {m}: gap to f64 {gap}, "
                                       f"cuBLAS f32's {lib_gap}")
                flop = 2.0 * m * n * k
                t = {"product": name, "m": m, "n": n, "k": k, "gelu": gelu,
                     "tile": gk.SHAPES[gk.tile_shape(m, n, dev)],
                     "f64_gap": gap, "cublas_f32_f64_gap": lib_gap, "plain_rel": plain_rel,
                     "ms": _median_ms(lambda: gk.linear_tf32x3(x, hi, lo, b, gelu)),
                     "plain_ms": _median_ms(lambda: gk.reference_linear(x, hi, lo, b, gelu)),
                     "library_ms": _median_ms(lib),
                     **_bound(4.0 * (m * k + n * k + n + m * n), flop, TF32_FLOPS),
                     "bound_3xtf32_ms": 1e3 * 3 * flop / TF32_FLOPS}
                t["share"] = t["bound_ms"] / t["ms"]
                t["share_3xtf32"] = t["bound_3xtf32_ms"] / t["ms"]
                t["tflops"] = flop / t["ms"] / 1e9
                t["library_tflops"] = flop / t["library_ms"] / 1e9
                rows.append(t)
                log("gemm_tf32x3", **t, bit_identical_repeat=True,
                    library="F.linear f32 (cuBLAS, TF32 off)" + (" + F.gelu" if gelu else ""))
                del x, w, b, hi, lo, y, y2, plain, ref, want
                torch.cuda.empty_cache()
    layer = {m: {"ms": sum(r["ms"] for r in rows if r["m"] == m),
                 "library_ms": sum(r["library_ms"] for r in rows if r["m"] == m)}
             for m in GEMM_ROWS}
    log("gemm_tf32x3", layer_ms=json.dumps(layer), launches=gk.launches - before,
        replaces="none: the JAX package leaves these products to XLA",
        phase_wall_s=time.perf_counter() - t0)
    return {"products": rows, "layer": layer}


def check_flash(dev):
    """K2 and the fused K3/K4 against their plain versions; each timed
    against its plain version and its library yardstick."""
    import torch

    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa

    res = {"fwd": {"max_abs_err": 0.0}, "dq": {"max_abs_err": 0.0, "dbias_max_abs_err": 0.0},
           "dkv": {"max_abs_err": 0.0}}
    with torch.no_grad():
        for i, shape in enumerate(CHECK_SHAPES):
            q, k, v, _, mask = _attention_inputs(shape, i, dev)
            bias = fa.padding_bias(mask)
            out, lse = fa.flash_attention_fwd(q, k, v, bias)
            out2, lse2 = fa.flash_attention_fwd(q, k, v, bias)
            ref_out, ref_lse = fa.reference_attention(q, k, v, bias)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref_out, **TOL)
            torch.testing.assert_close(lse, ref_lse, **TOL)
            if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
                raise RuntimeError(f"non-finite K2 output at {shape}")
            if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
                raise RuntimeError(f"K2 differs between two calls at {shape}")
            err = max(_max_err(out, ref_out), _max_err(lse, ref_lse))
            rel = _max_err(out, ref_out) / max(ref_out.abs().max().item(), 1e-30)
            if not rel <= FWD_REL:
                raise RuntimeError(f"K2 out at {shape}: {rel} of max|plain|")
            res["fwd"]["max_abs_err"] = max(res["fwd"]["max_abs_err"], err)
            res["fwd"]["rel_err"] = max(res["fwd"].get("rel_err", 0.0), rel)
            log("kernels", check="flash_attention_fwd", shape=shape, max_abs_err=err,
                rel_err=rel, bit_identical_repeat=True)
        for i, shape in enumerate(BWD_SHAPES):
            q, k, v, do, mask = _attention_inputs(shape, 100 + i, dev)
            bias = fa.padding_bias(mask)
            out, lse = fa.flash_attention_fwd(q, k, v, bias)
            got = fa.flash_attention_bwd(q, k, v, bias, out, lse, do)
            again = fa.flash_attention_bwd(q, k, v, bias, out, lse, do)
            ref = fa.attention_bwd_reference(q, k, v, bias, out, lse, do)
            torch.cuda.synchronize()
            errs, rel = {}, {}
            for name, a, a2, r in zip(("dq", "dk", "dv", "dbias"), got, again, ref):
                torch.testing.assert_close(a, r, **BWD_TOL, msg=f"{name} at {shape}")
                if not torch.isfinite(a).all():
                    raise RuntimeError(f"non-finite K3/K4 {name} at {shape}")
                if not torch.equal(a, a2):
                    raise RuntimeError(f"K3/K4 {name} differs between two calls at {shape}")
                errs[name] = _max_err(a, r)
                rel[name] = errs[name] / max(r.abs().max().item(), 1e-30)
                if name != "dbias" and not rel[name] <= BWD_REL:
                    raise RuntimeError(f"K3/K4 {name} at {shape}: {rel[name]} of max|plain|")
            res["dq"]["max_abs_err"] = max(res["dq"]["max_abs_err"], errs["dq"])
            res["dq"]["dbias_max_abs_err"] = max(res["dq"]["dbias_max_abs_err"], errs["dbias"])
            res["dkv"]["max_abs_err"] = max(res["dkv"]["max_abs_err"], errs["dk"], errs["dv"])
            log("kernels", check="flash_attention_bwd", shape=shape, bit_identical_repeat=True,
                max_abs_err=json.dumps(errs, separators=(",", ":")),
                rel_err=json.dumps(rel, separators=(",", ":")))

        # K2: serving bucket and training shape; kernel, plain, library
        for key, shape, seed in (("serve", SERVING_SHAPE, 99), ("train", TRAIN_SHAPE, 97),
                                 ("text_tower", TEXT_TOWER_SHAPE, 96)):
            q, k, v, do, mask = _attention_inputs(shape, seed, dev)
            bias = fa.padding_bias(mask)
            lib_err = _max_err(_sdpa(q, k, v, bias), fa.reference_attention(q, k, v, bias)[0])
            t = {"ms": _median_ms(lambda: fa.flash_attention_fwd(q, k, v, bias)),
                 "plain_ms": _median_ms(lambda: fa.reference_attention(q, k, v, bias)),
                 "library_ms": _median_ms(lambda: _sdpa(q, k, v, bias)), **_fwd_bound(shape)}
            log("kernels", time="flash_attention_fwd", shape=shape, **t,
                library="SDPA EFFICIENT_ATTENTION f32", library_max_abs_err_vs_plain=lib_err,
                timing="median of 30 blocks of 10 calls behind a sleep lead")
            if key == "serve":
                res["fwd"].update(t)
            else:
                res["fwd"][f"{key}_shape"] = {"shape": list(shape), **t}
            del q, k, v, do, mask, bias
            torch.cuda.empty_cache()
        res["fwd"]["library_call"] = ("torch.nn.functional.scaled_dot_product_attention(q, k, v, "
                                      "attn_mask=bias) under sdpa_kernel(EFFICIENT_ATTENTION), f32")
        res["fwd"]["sweep"] = sweep_flash(dev)

        q, k, v, do, mask = _attention_inputs(TRAIN_SHAPE, 98, dev)
        bias = fa.padding_bias(mask)
        out, lse = fa.flash_attention_fwd(q, k, v, bias)
        ms = _median_ms(lambda: fa.flash_attention_bwd(q, k, v, bias, out, lse, do,
                                                       with_dbias=False), runs=20)
        plain_ms = _median_ms(lambda: fa.attention_bwd_reference(q, k, v, bias, out, lse, do),
                              runs=20)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    lib_out = _sdpa(qg, kg, vg, bias)  # the bias takes no gradient, as in the trainer
    lib_grads = torch.autograd.grad(lib_out, (qg, kg, vg), do, retain_graph=True)
    ref = fa.attention_bwd_reference(q, k, v, bias, out, lse, do)
    lib_err = max(_max_err(a, r) for a, r in zip(lib_grads, ref))
    library_ms = _median_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                                        retain_graph=True), runs=20)
    del lib_out, lib_grads
    bound = _bwd_bound(TRAIN_SHAPE)
    for key in ("dq", "dkv"):
        res[key].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound,
                        library_call="torch.autograd.grad of the SDPA call above (its "
                                     "memory-efficient f32 backward) for q, k, v",
                        shared="one fused kernel computes K3's and K4's outputs: launches "
                               "and ms are the one kernel's (delta included, no dbias, as "
                               "the trainer calls it)")
    log("kernels", time="flash_attention_bwd (fused K3+K4, delta, no dbias)", shape=TRAIN_SHAPE,
        ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound,
        library="SDPA EFFICIENT_ATTENTION f32 backward", library_max_abs_err_vs_plain=lib_err,
        timing="median of 20 blocks of 10 calls")
    return res


def sweep_flash(dev, bf16=False):
    """K2 (or its bf16 mode) across S at B x 6 heads with B * S = 16384:
    kernel, plain and SDPA ms at D = 128 (S = 64 ... 2048), D = 64 (S = 64,
    2048) and the wide heads (D = 192, 256 at S = 512)."""
    import torch

    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa

    if bf16:
        name, kernel, plain, library = ("flash_attention_fwd_bf16", fa.flash_attention_fwd_bf16,
                                        fa.reference_attention_bf16, _sdpa_bf16)
        dtype, bound = torch.bfloat16, _fwd_bf16_bound
    else:
        name, kernel, plain, library = ("flash_attention_fwd", fa.flash_attention_fwd,
                                        fa.reference_attention, _sdpa)
        dtype, bound = torch.float32, _fwd_bound
    rows = []
    with torch.no_grad():
        for d, s in SWEEP:
            shape = (16384 // s, 6, s, d)
            q, k, v, _, mask = _attention_inputs(shape, s + d, dev)
            q, k, v = (t.to(dtype) for t in (q, k, v))
            bias = fa.padding_bias(mask, dtype)
            row = {"shape": list(shape),
                   "ms": _median_ms(lambda: kernel(q, k, v, bias), runs=10),
                   "plain_ms": _median_ms(lambda: plain(q, k, v, bias), runs=10),
                   "library_ms": _median_ms(lambda: library(q, k, v, bias), runs=10)}
            row.update((key, bound(shape)[key]) for key in ("bound_ms", "bound_by"))
            log("kernels", sweep=name, **row)
            rows.append(row)
            del q, k, v, mask, bias
    return rows


def _fwd_bf16_bound(shape) -> dict:
    b, h, s, d = shape  # q, k, v, out bf16; bias bf16; lse f32; Q K^T and P V in bf16
    return _bound(2 * (4 * b * h * s * d + b * s) + 4 * b * h * s, 4 * b * h * s * s * d,
                  BF16_FLOPS)


def _sdpa_bf16(q, k, v, bias):
    """The library yardstick of K2's bf16 mode: SDPA with bf16 q, k, v and the
    same additive bias, on whichever backend it picks."""
    import torch

    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def _sdpa_backend(q, k, v, bias) -> str:
    """The SDPA backend PyTorch picks for these inputs (its dispatcher's choice)."""
    import torch
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(int(torch._fused_sdp_choice(q, k, v, attn_mask=bias))).name
    except Exception as exc:  # noqa: BLE001 - a label only, never a path of the port
        return f"unknown ({type(exc).__name__})"


def check_flash_bf16(dev):
    """K2's bf16 mode against its plain twin (BF16_SHAPES, a fully masked row
    in each), twice for bit identity; timed at the serving and training
    shapes against the twin, its bound and SDPA in bf16."""
    import torch

    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa

    res = {"max_abs_err": 0.0, "rel_err": 0.0, "lse_max_abs_err": 0.0}
    with torch.no_grad():
        for i, shape in enumerate(BF16_SHAPES):
            q, k, v, _, mask = _attention_inputs(shape, 200 + i, dev)
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            bias = fa.padding_bias(mask, torch.bfloat16)
            out, lse = fa.flash_attention_fwd_bf16(q, k, v, bias)
            out2, lse2 = fa.flash_attention_fwd_bf16(q, k, v, bias)
            ref_out, ref_lse = fa.reference_attention_bf16(q, k, v, bias)
            torch.cuda.synchronize()
            if not (torch.isfinite(out.float()).all() and torch.isfinite(lse).all()):
                raise RuntimeError(f"non-finite K2-bf16 output at {shape}")
            if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
                raise RuntimeError(f"K2-bf16 differs between two calls at {shape}")
            err = _max_err(out.float(), ref_out.float())
            rel = err / max(ref_out.float().abs().max().item(), 1e-30)
            if not rel <= BF16_REL:
                raise RuntimeError(f"K2-bf16 out at {shape}: {rel} of max|plain|")
            torch.testing.assert_close(lse, ref_lse, atol=BF16_LSE, rtol=BF16_LSE)
            lse_err = _max_err(lse, ref_lse)
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["rel_err"] = max(res["rel_err"], rel)
            res["lse_max_abs_err"] = max(res["lse_max_abs_err"], lse_err)
            log("kernels", check="flash_attention_fwd_bf16", shape=shape, max_abs_err=err,
                rel_err=rel, lse_max_abs_err=lse_err, bit_identical_repeat=True)
        for key, shape, seed in (("serve", SERVING_SHAPE, 299), ("train", TRAIN_SHAPE, 297)):
            q, k, v, _, mask = _attention_inputs(shape, seed, dev)
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            bias = fa.padding_bias(mask, torch.bfloat16)
            backend = _sdpa_backend(q, k, v, bias)
            lib_err = _max_err(_sdpa_bf16(q, k, v, bias).float(),
                               fa.reference_attention_bf16(q, k, v, bias)[0].float())
            call = lambda: fa.flash_attention_fwd_bf16(q, k, v, bias)  # noqa: E731
            t = {"ms": _median_ms(call),
                 # the wrapper's checks and the four tensor maps' encode included
                 "ms_host_included": _median_ms(call, lead=False),
                 "plain_ms": _median_ms(lambda: fa.reference_attention_bf16(q, k, v, bias)),
                 "library_ms": _median_ms(lambda: _sdpa_bf16(q, k, v, bias)),
                 "library_ms_host_included": _median_ms(lambda: _sdpa_bf16(q, k, v, bias),
                                                        lead=False),
                 **_fwd_bf16_bound(shape)}
            log("kernels", time="flash_attention_fwd_bf16", shape=shape, **t,
                library=f"SDPA bf16, backend {backend}", library_max_abs_err_vs_plain=lib_err,
                timing="median of 30 blocks of 10 calls behind a sleep lead; "
                       "host_included without one")
            if key == "serve":
                res.update(t, library_backend=backend)
            else:
                res["train_shape"] = {"shape": list(shape), "library_backend": backend, **t}
    res["library_call"] = ("torch.nn.functional.scaled_dot_product_attention(q, k, v, "
                           "attn_mask=bias) with bf16 q, k, v and bias, the backend it picks")
    res["design"] = ("persistent warp-specialised: TMA loads (128-byte swizzle, mbarrier ring), "
                     "wgmma S = Q K^T and O += P V (P from registers), TMA-store epilogue")
    res["smem_bytes"] = {d: fa._bf16_smem(d) for d in fa.HEAD_DIMS}
    res["sweep"] = sweep_flash(dev, bf16=True)
    return res


def _bwd_bf16_bound(shape) -> dict:
    b, h, s, d = shape  # q, k, v, out, dO, bias bf16 and lse f32 in; dq, dk, dv bf16 out; 5 bf16 products
    return _bound(2 * (8 * b * h * s * d + b * s) + 4 * b * h * s, 10 * b * h * s * s * d, BF16_FLOPS)


def check_flash_bwd_bf16(dev, f32_bwd_ms):
    """K3/K4's bf16 mode against its plain twin (BWD_BF16_SHAPES, a fully
    masked row in each, dbias on), twice for bit identity; timed at the
    training shape (no dbias, as the trainer calls it) against the twin, its
    bound, the backward of `_sdpa_bf16`'s call and the f32 fused backward."""
    import torch

    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa

    res = {"max_abs_err": 0.0, "rel_err": 0.0, "dbias_max_abs_err": 0.0, "dbias_rel_err": 0.0}
    with torch.no_grad():
        for i, shape in enumerate(BWD_BF16_SHAPES):
            q, k, v, do, mask = (t.to(torch.bfloat16) for t in _attention_inputs(shape, 400 + i, dev))
            bias = fa.padding_bias(mask.float(), torch.bfloat16)
            out, lse = fa.flash_attention_fwd_bf16(q, k, v, bias)
            got = fa.flash_attention_bwd_bf16(q, k, v, bias, out, lse, do)
            again = fa.flash_attention_bwd_bf16(q, k, v, bias, out, lse, do)
            ref = fa.attention_bwd_reference_bf16(q, k, v, bias, out, lse, do)
            torch.cuda.synchronize()
            rel = {}
            for name, a, a2, r in zip(("dq", "dk", "dv", "dbias"), got, again, ref):
                if not torch.isfinite(a.float()).all():
                    raise RuntimeError(f"non-finite K3/K4-bf16 {name} at {shape}")
                if not torch.equal(a, a2):
                    raise RuntimeError(f"K3/K4-bf16 {name} differs between two calls at {shape}")
                err = _max_err(a.float(), r.float())
                rel[name] = err / max(r.float().abs().max().item(), 1e-30)
                if not rel[name] <= BWD_BF16_REL:
                    raise RuntimeError(f"K3/K4-bf16 {name} at {shape}: {rel[name]} of max|twin|")
                key = "dbias_" if name == "dbias" else ""
                res[key + "max_abs_err"] = max(res[key + "max_abs_err"], err)
                res[key + "rel_err"] = max(res[key + "rel_err"], rel[name])
            log("kernels", check="flash_attention_bwd_bf16", shape=shape, bit_identical_repeat=True,
                rel_err=json.dumps({k: round(x, 7) for k, x in rel.items()}, separators=(",", ":")))

        q, k, v, do, mask = (t.to(torch.bfloat16) for t in _attention_inputs(TRAIN_SHAPE, 398, dev))
        bias = fa.padding_bias(mask.float(), torch.bfloat16)
        out, lse = fa.flash_attention_fwd_bf16(q, k, v, bias)
        ms = _median_ms(lambda: fa.flash_attention_bwd_bf16(q, k, v, bias, out, lse, do,
                                                            with_dbias=False), runs=20)
        plain_ms = _median_ms(lambda: fa.attention_bwd_reference_bf16(q, k, v, bias, out, lse, do),
                              runs=20)
    backend = _sdpa_backend(q, k, v, bias)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    library_ms, lib_err, lib_note, lib_nonfinite = None, None, "", None
    try:
        lib_out = _sdpa_bf16(qg, kg, vg, bias)  # the bias takes no gradient, as in the trainer
        lib_grads = torch.autograd.grad(lib_out, (qg, kg, vg), do, retain_graph=True)
        ref = fa.attention_bwd_reference_bf16(q, k, v, bias, out, lse, do)
        # on fully masked rows the twin follows the TPU kernels (P = 1 per
        # key) and SDPA need not: compare the batches with a valid key, and
        # count SDPA's non-finite gradients on the others
        valid = mask.sum(dim=-1) > 0
        lib_err = max(_max_err(a[valid].float(), r[valid].float()) for a, r in zip(lib_grads, ref))
        lib_nonfinite = {"masked_batches": int((~valid).sum()), "nonfinite": sum(
            int((~torch.isfinite(a[~valid].float())).sum()) for a in lib_grads)}
        library_ms = _median_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                                            retain_graph=True), runs=20)
        del lib_out, lib_grads
    except RuntimeError as exc:  # a yardstick only: the port never calls SDPA
        lib_note = f"{type(exc).__name__}: {str(exc)[:200]}"
    bound = _bwd_bf16_bound(TRAIN_SHAPE)
    res.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, library_backend=backend,
               f32_bwd_ms=f32_bwd_ms, **bound,
               library_call="torch.autograd.grad of _sdpa_bf16's call (SDPA with bf16 q, k, v "
                            "and the bias, the backend it picks) for q, k, v",
               shared="one fused kernel computes K3's and K4's outputs: launches and ms are the "
                      "one kernel's (delta included, no dbias, as the trainer calls it)")
    log("kernels", time="flash_attention_bwd_bf16 (fused K3+K4, delta, no dbias)",
        shape=TRAIN_SHAPE, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        f32_bwd_ms=f32_bwd_ms, **bound, library=f"SDPA bf16 backward, backend {backend}",
        library_max_abs_err_vs_twin_valid_rows=lib_err,
        library_fully_masked=json.dumps(lib_nonfinite), library_error=json.dumps(lib_note),
        timing="median of 20 blocks of 10 calls behind a sleep lead")
    return res


def _sdpa_bwd_ms(q, k, v, bias, do, bf16):
    """(ms, note) of torch.autograd.grad of the SDPA yardstick's call for q,
    k, v (`_sdpa_bf16` or `_sdpa`); ms None with the error's note when SDPA
    refuses the inputs (a yardstick only: the port never calls SDPA)."""
    import torch

    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    try:
        with torch.enable_grad():
            out = (_sdpa_bf16 if bf16 else _sdpa)(qg, kg, vg, bias)
        return _median_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True),
                          runs=20), ""
    except RuntimeError as exc:
        return None, f"{type(exc).__name__}: {str(exc)[:200]}"


def check_pipeline_shapes(dev):
    """K2 (f32) and the fused K3/K4 in both modes at the pipelined tower's
    microbatch shapes (PP_SHAPES): each against its plain version (K3/K4 at
    BWD_REL / BWD_BF16_REL of max|plain|), then timed against its bound and
    SDPA's call or backward at the same shape."""
    import torch

    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa

    res = {"fwd": [], "bwd": [], "bwd_bf16": []}
    for i, shape in enumerate(PP_SHAPES):
        q, k, v, do, mask = _attention_inputs(shape, 500 + i, dev)
        bias = fa.padding_bias(mask)
        with torch.no_grad():
            if shape not in CHECK_SHAPES:  # K2 f32 at this shape
                out, lse = fa.flash_attention_fwd(q, k, v, bias)
                ref_out, _ = fa.reference_attention(q, k, v, bias)
                rel = _max_err(out, ref_out) / max(ref_out.abs().max().item(), 1e-30)
                if not rel <= FWD_REL:
                    raise RuntimeError(f"K2 out at {shape}: {rel} of max|plain|")
                t = {"shape": list(shape), "rel_err": rel,
                     "ms": _median_ms(lambda: fa.flash_attention_fwd(q, k, v, bias)),
                     "plain_ms": _median_ms(lambda: fa.reference_attention(q, k, v, bias)),
                     "library_ms": _median_ms(lambda: _sdpa(q, k, v, bias)), **_fwd_bound(shape)}
                res["fwd"].append(t)
                log("kernels", time="flash_attention_fwd (pipelined microbatch)", **t)
            for bf16 in (False, True):
                if bf16:
                    qq, kk, vv, dd = (t.to(torch.bfloat16) for t in (q, k, v, do))
                    bb = fa.padding_bias(mask, torch.bfloat16)
                    fwd, bwd, ref_bwd = (fa.flash_attention_fwd_bf16, fa.flash_attention_bwd_bf16,
                                         fa.attention_bwd_reference_bf16)
                    bound, limit = _bwd_bf16_bound(shape), BWD_BF16_REL
                else:
                    qq, kk, vv, dd, bb = q, k, v, do, bias
                    fwd, bwd, ref_bwd = (fa.flash_attention_fwd, fa.flash_attention_bwd,
                                         fa.attention_bwd_reference)
                    bound, limit = _bwd_bound(shape), BWD_REL
                out, lse = fwd(qq, kk, vv, bb)
                got = bwd(qq, kk, vv, bb, out, lse, dd, with_dbias=False)
                ref = ref_bwd(qq, kk, vv, bb, out, lse, dd)
                rel = max(_max_err(a.float(), r.float()) / max(r.float().abs().max().item(), 1e-30)
                          for a, r in zip(got[:3], ref[:3]))
                if not rel <= limit:
                    raise RuntimeError(f"K3/K4{'-bf16' if bf16 else ''} at {shape}: {rel} of "
                                       "max|plain|")
                ms = _median_ms(lambda: bwd(qq, kk, vv, bb, out, lse, dd, with_dbias=False),
                                runs=20)
                library_ms, note = _sdpa_bwd_ms(qq, kk, vv, bb, dd, bf16)
                t = {"shape": list(shape), "rel_err": rel, "ms": ms, "library_ms": library_ms,
                     "library_error": note, **bound}
                res["bwd_bf16" if bf16 else "bwd"].append(t)
                log("kernels", time=f"flash_attention_bwd{'_bf16' if bf16 else ''} (fused "
                    "K3+K4, pipelined microbatch, delta, no dbias)", **t,
                    library=f"SDPA {'bf16' if bf16 else 'f32 EFFICIENT_ATTENTION'} backward")
        del q, k, v, do, mask, bias
        torch.cuda.empty_cache()
    return res


def _hf_twin_inputs(kind, rng):
    """The main path's inputs of a twin: token ids and mask (ragged
    lengths, the longest at the bucket), or waveforms."""
    if kind == "w2v2":
        return (list(rng.standard_normal((HF_WAVES, HF_SAMPLES)).astype(np.float32)),)
    rows, seq = (HF_CHUNK, HF_CLIP_SEQ) if kind == "clip" else (HF_CHUNK, HF_SEQ)
    cfg = {"bert": HF_BERT, "roberta": HF_EMOTION, "clip": HF_CLIP}[kind]
    lengths = rng.integers(2, seq + 1, rows)
    lengths[0] = seq
    mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.float32)
    ids = rng.integers(3, cfg["vocab_size"] - 1, (rows, seq))
    if kind == "clip":  # <|endoftext|> (the largest id) closes each row and pads it
        ids[np.arange(seq)[None] >= (lengths - 1)[:, None]] = cfg["vocab_size"] - 1
    else:
        ids[mask == 0] = HF_EMOTION["pad_token_id"] if kind == "roberta" else 0
    return ids, mask


def phase_hf_twins(dev):
    """The ladders' HF twins at their published widths, weights from a seed
    (the card's machine has no transformers): K2 at the twins' shapes
    against its plain version, timed against its bound and SDPA f32; each
    twin's chunk through its entry point with the launches counted, against
    the same module with the plain attention, timed and profiled."""
    import importlib.metadata
    import importlib.util

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
    from ultrafnd_git_tpu_torch.kernels import gemm_tf32x3 as gk
    from ultrafnd_git_tpu_torch.models import bert, clip, roberta, w2v2

    from ultrafnd_git_tpu_torch.models.affective import emotion_rung
    from ultrafnd_git_tpu_torch.models.audio import SpectralForensics
    from ultrafnd_git_tpu_torch.models.encoders import text_rung
    from ultrafnd_git_tpu_torch.models.semantic import clip_rung

    t0 = time.perf_counter()
    present = importlib.util.find_spec("transformers") is not None
    log("hf_twins", transformers_importable=present,
        transformers_version=importlib.metadata.version("transformers") if present else None,
        note="the twins are built from constants either way")
    # what the ladders select on this machine (local weights or not)
    log("hf_twins", ladder_rungs=json.dumps({
        "text": text_rung() or "hash", "semantic": clip_rung() or "hash",
        "affective": emotion_rung() or "lexicon",
        "audio": "hf" if SpectralForensics().use_w2v2 else "spectral"}))
    k2 = []
    with torch.no_grad():
        for i, shape in enumerate(HF_K2_SHAPES):
            q, k, v, _, mask = _attention_inputs(shape, 600 + i, dev)
            # BERT / RoBERTa: the padding bias; wav2vec2: no mask (K2's zero bias)
            bias = fa.padding_bias(mask) if i == 0 else None
            out, lse = fa.flash_attention_fwd(q, k, v, bias)
            out2, lse2 = fa.flash_attention_fwd(q, k, v, bias)
            ref_out, ref_lse = fa.reference_attention(q, k, v, bias)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref_out, **TOL)
            torch.testing.assert_close(lse, ref_lse, **TOL)
            if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
                raise RuntimeError(f"K2 differs between two calls at {shape}")
            rel = _max_err(out, ref_out) / max(ref_out.abs().max().item(), 1e-30)
            if not rel <= FWD_REL:
                raise RuntimeError(f"K2 out at {shape}: {rel} of max|plain|")
            t = {"shape": list(shape), "bias": "padding" if bias is not None else "zeros",
                 "max_abs_err": max(_max_err(out, ref_out), _max_err(lse, ref_lse)),
                 "rel_err": rel,
                 "ms": _median_ms(lambda: fa.flash_attention_fwd(q, k, v, bias)),
                 "plain_ms": _median_ms(lambda: fa.reference_attention(q, k, v, bias)),
                 "library_ms": _median_ms(lambda: _sdpa(q, k, v, bias)), **_fwd_bound(shape)}
            k2.append(t)
            log("hf_twins", time="flash_attention_fwd", **t, bit_identical_repeat=True,
                library="SDPA EFFICIENT_ATTENTION f32 (no mask for the zero bias)")
            del q, k, v, mask, bias, out, out2, ref_out
            torch.cuda.empty_cache()

    builds = {  # module, config, wrapper over a state dict, its entry point
        "bert": (bert.BertEncoder, HF_BERT,
                 lambda sd: bert.DeviceBertEncoder(sd, None, max_length=HF_SEQ,
                                                   batch_size=HF_CHUNK, config=HF_BERT),
                 "encode_ids"),
        "roberta": (roberta.RobertaClassifier, HF_EMOTION,
                    lambda sd: roberta.DeviceEmotionClassifier(sd, None, max_length=HF_SEQ,
                                                               batch_size=HF_CHUNK,
                                                               config=HF_EMOTION),
                    "predict_ids"),
        "w2v2": (w2v2.Wav2Vec2Encoder, HF_W2V2,
                 lambda sd: w2v2.DeviceW2V2Encoder(sd, dim=128, batch_size=HF_WAVES,
                                                   config=HF_W2V2),
                 "encode_batch"),
        "clip": (clip.ClipTextEncoder, HF_CLIP,
                 lambda sd: clip.DeviceClipTextEncoder(sd, None, max_length=HF_CLIP_SEQ,
                                                       batch_size=HF_CHUNK, config=HF_CLIP),
                 "encode_ids"),
    }
    twins, launches, gemm_launches = {}, 0, 0
    for j, (kind, (module_cls, cfg, build, entry)) in enumerate(builds.items()):
        s = time.perf_counter()
        sd = bert.draw_weights_(module_cls.from_config(cfg), seed=700 + j).state_dict()
        twin = build(sd)
        del sd
        build_s = time.perf_counter() - s
        if twin.device.type != "cuda":
            raise RuntimeError(f"hf_twins: the {kind} twin is on {twin.device}")
        params = sum(p.numel() for p in twin.module.parameters())
        inputs = _hf_twin_inputs(kind, np.random.default_rng(800 + j))

        def chunk():
            return getattr(twin, entry)(*inputs)

        _reset_counts()  # this twin's main-path chunk only
        planned, gemm_before = bert.encode_chunks, gk.launches
        got = chunk()
        counted = _launch_counts()
        gemm_counted = gk.launches - gemm_before
        depth = cfg["num_hidden_layers"]
        # the BERT rung plans its own chunks by length (models/bert.plan_chunks)
        chunks = bert.encode_chunks - planned if kind == "bert" else 1
        expect = {"fwd": 0 if kind == "clip" else depth * chunks, "fwd_bf16": 0, "bwd": 0,
                  "bwd_bf16": 0, "adamw": 0}
        if counted != expect:
            raise RuntimeError(f"hf_twins {kind}: launches {counted}, expected {expect}")
        # the BERT rung's four products a layer a chunk on the 3xTF32 GEMM
        if gemm_counted != (4 * depth * chunks if kind == "bert" else 0):
            raise RuntimeError(f"hf_twins {kind}: gemm_tf32x3 launches {gemm_counted}")
        launches += counted["fwd"]
        gemm_launches += gemm_counted
        rows = len(inputs[0])
        width = {"bert": 768, "roberta": 7, "w2v2": 128, "clip": 512}[kind]
        if got.shape != (rows, width) or not np.isfinite(got).all():
            raise RuntimeError(f"hf_twins {kind}: output {got.shape}, finite "
                               f"{np.isfinite(got).all()}")
        if kind in ("bert", "clip") and np.abs(np.linalg.norm(got, axis=1) - 1).max() > 1e-4:
            raise RuntimeError(f"hf_twins {kind}: rows not L2-normalised")
        if kind == "roberta" and np.abs(got.sum(axis=1) - 1).max() > 1e-5:
            raise RuntimeError("hf_twins roberta: probabilities do not sum to 1")
        walls = []
        for _ in range(HF_TIMED):
            s = time.perf_counter()
            chunk()  # returns host numpy: synchronised
            walls.append(1e3 * (time.perf_counter() - s))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            chunk()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        k2_ms = sum(e.self_device_time_total for e in kernels if "flash" in e.key.lower()) / 1e3
        gemm_ms = sum(e.self_device_time_total for e in kernels if "gemm" in e.key.lower()) / 1e3
        plain_rel = None
        if kind != "clip":  # CLIP's attention is the plain one already
            bert.set_attention(twin.module, bert.plain_attention)
            plain = chunk()
            bert.set_attention(twin.module, fa.flash_attention)
            plain_rel = float(np.abs(got - plain).max() / max(np.abs(plain).max(), 1e-30))
            if not plain_rel <= HF_TWIN_REL:
                raise RuntimeError(f"hf_twins {kind}: K2 vs the plain attention {plain_rel} "
                                   f"of the largest value (bound {HF_TWIN_REL})")
        chunk_ms = statistics.median(walls)
        twins[kind] = {"params": params, "rows": rows, "chunks": chunks,
                       "launches_a_chunk": counted["fwd"] // chunks,
                       "chunk_ms": chunk_ms, "chunk_ms_range": [min(walls), max(walls)],
                       "chunk_device_ms": device_ms, "chunk_k2_ms": k2_ms,
                       "k2_share": k2_ms / device_ms if device_ms else None,
                       "chunk_gemm_ms": gemm_ms,
                       "idle_share": max(0.0, 1.0 - device_ms / chunk_ms),
                       "kernel_vs_plain_attention_rel": plain_rel}
        log("hf_twins", twin=kind, config=json.dumps(cfg, separators=(",", ":")),
            build_s=build_s, **twins[kind])
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
            log("hf_twins", twin=kind, kernel=json.dumps(e.key[:90]), calls=e.count,
                device_ms=e.self_device_time_total / 1e3)
        del twin, got
        torch.cuda.empty_cache()
    log("hf_twins", k2_launches=launches, gemm_launches=gemm_launches,
        phase_wall_s=time.perf_counter() - t0)
    return {"k2_shapes": k2, "twins": twins, "launches": {"fwd": launches},
            "gemm_launches": gemm_launches}


def full_width_params(dev):
    """The trainer's parameter tree at full width (about 52 M parameters)."""
    import torch

    from ultrafnd_git_tpu_torch.models.classifier import DeepTruthClassifier
    from ultrafnd_git_tpu_torch.models.fusion import CrossModalTransformer
    from ultrafnd_git_tpu_torch.models.gnn import SimpleGCN
    from ultrafnd_git_tpu_torch.models.initializers import jax_init_
    from ultrafnd_git_tpu_torch.models.transformer import TextTransformer
    from ultrafnd_git_tpu_torch.utils.config import classifier_config

    gen = torch.Generator().manual_seed(3)
    mods = {"fusion": CrossModalTransformer(), "clf": DeepTruthClassifier(**classifier_config()),
            "gnn": SimpleGCN(416, 256, 128), "text_tower": TextTransformer(**TOWER)}
    return {k: jax_init_(k, m, gen).to(dev) for k, m in mods.items()}


def _library_adamw(leaves, tx, grad_scale, dev):
    """(call, restore): one `torch._fused_adamw_` over K1's (p, m, v, g)
    `leaves` with `tx`'s hyperparameters, and the copy back of the grads it
    overwrites (run before each timed block, untimed)."""
    import torch

    ps, ms_, vs, gs = (list(t) for t in zip(*leaves))
    # the raw op does not count steps (torch.optim adds 1 before it): step 1,
    # the bias correction of K1's first step; a step of 0 divides by zero
    steps = [torch.ones((), device=dev) for _ in leaves]
    saved = [t.clone() for t in gs]
    call = lambda: torch._fused_adamw_(  # noqa: E731
        ps, gs, ms_, vs, [], steps, lr=2e-4, beta1=tx.b1, beta2=tx.b2,
        weight_decay=tx.weight_decay, eps=tx.eps, amsgrad=False, maximize=False,
        grad_scale=grad_scale, found_inf=None)
    return call, lambda: torch._foreach_copy_(gs, saved)


def check_adamw(dev):
    """K1 bit for bit against the plain update over 3 steps, then timed."""
    import copy

    import torch

    from ultrafnd_git_tpu_torch.kernels import adamw as aw
    from ultrafnd_git_tpu_torch.training.state import make_optimizer

    params = full_width_params(dev)
    plain_params = copy.deepcopy(params)
    fused = make_optimizer(2e-4, 1e-4, 5.0, steps_per_epoch=1)  # the trainer's FusedAdamW
    plain = aw.AdamW(fused.schedule, fused.weight_decay, fused.grad_clip)
    sf, sp = fused.init(params), plain.init(plain_params)
    g = torch.Generator(device=dev).manual_seed(4)
    max_err = 0.0
    scalar_leaves = 0
    for step in range(3):  # the first step is under the clip, the others over
        grads = {part: {n: torch.randn(p.shape, generator=g, device=dev) * (1e-4 + 1e-3 * step)
                        for n, p in m.named_parameters()} for part, m in params.items()}
        scalar_leaves += _unaligned_leaves(fused._leaves(params, sf, grads))
        fused.apply(params, sf, grads)
        plain.apply(plain_params, sp, grads)
    torch.cuda.synchronize()
    if scalar_leaves:
        raise RuntimeError("K1 sent a leaf of the full-width tree down its scalar path")
    n_params = 0
    for part, mod in params.items():
        for n, p in mod.named_parameters():
            pairs = ((p, dict(plain_params[part].named_parameters())[n]),
                     (sf["mu"][part][n], sp["mu"][part][n]), (sf["nu"][part][n], sp["nu"][part][n]))
            for a, b in pairs:
                if not torch.equal(a, b):
                    raise RuntimeError(f"K1 differs from the plain update at {part}.{n}")
                max_err = max(max_err, _max_err(a, b))
            n_params += p.numel()
    leaves = fused._leaves(params, sf, grads)
    scal = fused.scalars(grads, sf["count"])
    ms = _median_ms(lambda: aw.fused_adamw_(leaves, scal), runs=20, calls=5)
    # with the host's work per call (checks of 564 tensors, the launch) included
    ms_host = _median_ms(lambda: aw.fused_adamw_(leaves, scal), runs=20, calls=5, lead=False)
    # about 2,100 small launches a call: more than CUDA queues ahead, so no lead
    plain_ms = _median_ms(lambda: plain._update(leaves, scal), runs=20, calls=5, lead=False)
    # the yardstick: torch's fused AdamW over the same leaves, the clip
    # coefficient min(1, clip / gnorm) passed as grad_scale = 1 / coefficient
    grad_scale = torch.clamp(scal[0] / fused.grad_clip, min=1.0).reshape(())
    library, restore = _library_adamw(leaves, fused, grad_scale, dev)
    library_ms = _median_ms(library, runs=20, calls=5, before_block=restore)
    library_ms_host = _median_ms(library, runs=20, calls=5, before_block=restore, lead=False)
    del library, restore
    # p, g, m, v in; p, m, v out; f32 arithmetic
    bound = _bound(4 * 7 * n_params, ADAMW_FLOP * n_params, F32_FLOPS)
    log("kernels", check="adamw", params=n_params, leaves=len(leaves), steps=3,
        bit_identical=True, scalar_leaves=0, ms=ms, ms_host_included=ms_host, plain_ms=plain_ms,
        library_ms=library_ms, library_ms_host_included=library_ms_host, **bound,
        timing="median of 20 blocks of 5 updates (fixed scalars) behind a sleep lead; "
               "host_included and plain without one")
    return {"max_abs_err": max_err, "ms": ms, "ms_host_included": ms_host, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_ms_host_included": library_ms_host,
            "library_call": "torch._fused_adamw_ over the same leaves, grad_scale = "
                            "1 / clip coefficient, the grads restored before each timed "
                            "block; a yardstick, not a reference: it decays "
                            "p by (1 - lr wd) before the moment update and divides the "
                            "gradient by grad_scale, where K1 clips by multiplying, adds "
                            "wd p to the update and folds lr in last",
            **bound}


def synthetic_corpus(n, rng):
    """The cache contract at FakeSV scale: text 768, audio 128, visual 512,
    temporal 256, tower ids/mask (64), OCR sets from a 4096-token vocab."""
    from ultrafnd_git_tpu_torch.data.cache import TOWER_IDS_LEN, TOWER_VOCAB

    vocab = np.array([f"tok{i}" for i in range(OCR_VOCAB)])
    split = rng.permutation(n)
    k1, k2 = int(0.7 * n), int(0.85 * n)
    lengths = rng.integers(1, TOWER_IDS_LEN + 1, size=n)
    return {
        "ids": np.array([f"v{i}" for i in range(n)], dtype=object),
        "labels": rng.integers(0, 2, size=n).astype(np.int64),
        "text": rng.standard_normal((n, 768)).astype(np.float32),
        "audio": rng.standard_normal((n, 128)).astype(np.float32),
        "visual": rng.standard_normal((n, 512)).astype(np.float32),
        "temporal": rng.standard_normal((n, 256)).astype(np.float32),
        "aux": rng.uniform(size=(n, 2)).astype(np.float32),
        "text_ids": rng.integers(1, TOWER_VOCAB, size=(n, TOWER_IDS_LEN)).astype(np.int32),
        "text_mask": (np.arange(TOWER_IDS_LEN)[None] < lengths[:, None]).astype(np.float32),
        "ocr_sets": [set(rng.choice(vocab, size=TOKENS_PER_DOC, replace=False))
                     for _ in range(n)],
        "split": (split[:k1], split[k1:k2], split[k2:]),
    }


def synthetic_records(count, corpus, rng):
    """Chinese titles and comments; half the records copy most of a corpus
    document's OCR tokens, so their graph rows link into the corpus."""
    recs = []
    for i in range(count):
        words = list(rng.choice(CJK_WORDS, size=int(rng.integers(2, 9))))
        ocr = list(rng.choice(CJK_WORDS, size=4))
        if i % 2 == 0:
            doc = sorted(corpus["ocr_sets"][int(rng.integers(len(corpus["ocr_sets"])))])
            ocr += doc[:8]
        recs.append({
            "video_id": f"req_{count}_{i}",
            "title": " ".join(words) + f" 第{i}期",
            "ocr": " ".join(ocr) if i % 5 else "",
            "comments": ["这是真的吗", "假的 别信"][: int(rng.integers(0, 3))],
        })
    return recs


def build_model_dir(root):
    """A full-width tower model with seeded weights (torch.Generator(0))
    over a synthetic FakeSV-scale corpus: the trainer's cache and the
    align weights of its export."""
    from ultrafnd_git_tpu_torch.serving import write_seeded_model_dir

    meta = {
        "cfg": {
            "train_text_tower": True,
            "text_tower_depth": TOWER["depth"],
            "text_tower_heads": TOWER["heads"],
            "tower_gelu": TOWER["gelu"],
            "use_gnn": True,
            "gnn_dim": 128,
            "gnn_overlap_thresh": 0.12,
            "hash_salt": "",
            "seed": 0,
        },
        "fusion": {"hidden": 512, "use_gnn": True, "gnn_dim": 128, "text_dim": 768,
                   "audio_dim": 128, "visual_dim": 512, "temporal_dim": 256},
        "classifier": {"hidden": 512, "num_classes": 2, "use_aux": True,
                       "aux_dim": 2, "node_trees": 6, "node_depth": 4,
                       "node_tau": 10.0, "temperature_init": 1.0},
        "gnn": {"in_dim": 416, "hid": 256, "out_dim": 128},
        "align": {"in_dim": 768, "out_dim": 256},
        "text_tower": TOWER,
    }
    corpus = synthetic_corpus(N_CORPUS, np.random.default_rng(0))
    write_seeded_model_dir(root, meta, corpus, seed=0)
    return corpus


def _train_cfg(out_dir, model_dir, sparse_graph=False, bf16=False):
    from ultrafnd_git_tpu_torch.training.trainer import TrainConfig

    return TrainConfig(out_dir=str(out_dir), model_dir=str(model_dir),
                       batch_size=TRAIN_BATCH, epochs=1, seed=0, train_text_tower=True,
                       text_tower_depth=TOWER["depth"], text_tower_heads=TOWER["heads"],
                       tower_gelu=TOWER["gelu"], fused_adamw=True, sparse_graph=sparse_graph,
                       bf16_compute=bf16)


def _grad_gap(gpu, cpu, rows=64):
    """One dropout-off gradient, GPU against CPU, over `rows` training rows:
    ((largest leaf error relative to the leaf's largest CPU value, leaf),
    (largest relative L2 error of a leaf, leaf))."""
    import torch

    idx = torch.from_numpy(np.asarray(gpu.tr_idx[:rows], np.int64))
    mask = torch.ones(rows)
    _, g_gpu, _ = gpu.grads_of(idx.to(gpu.device), mask.to(gpu.device))
    _, g_cpu, _ = cpu.grads_of(idx, mask)
    return _leaf_gaps(g_gpu, g_cpu)


def _leaf_gaps(g_gpu, g_cpu):
    """((largest leaf error relative to the leaf's largest CPU value, leaf),
    (largest relative L2 error of a leaf, leaf)) of two gradient trees."""
    worst, worst_l2 = (0.0, ""), (0.0, "")
    for part, leaves in g_cpu.items():
        for name, c in leaves.items():
            d = g_gpu[part][name].cpu() - c
            rel = d.abs().max().item() / max(c.abs().max().item(), 1e-30)
            l2 = d.norm().item() / max(c.norm().item(), 1e-30)
            worst = max(worst, (rel, f"{part}.{name}"))
            worst_l2 = max(worst_l2, (l2, f"{part}.{name}"))
    return worst, worst_l2


def _tree_gap(got, ref):
    """The relative L2 error of a whole tree of tensors (every leaf at once)."""
    import torch

    pairs = [(got[part][name].cpu().double(), c.double())
             for part, leaves in ref.items() for name, c in leaves.items()]
    err = sum(float(((a - b) ** 2).sum()) for a, b in pairs)
    return (err / max(sum(float((b ** 2).sum()) for _, b in pairs), 1e-300)) ** 0.5


def profile_step(trainer, median_step_ms, rows=12, phase="profile", step=None):
    """Device time of one steady train step by kernel (torch.profiler; the
    device total sums the kernel events, as the profiler's own table does)
    and the device's idle share of a step: 1 - that device time / the
    median wall time of the unprofiled steps (host clock around a
    synchronised step). The profiled step's own wall time is printed too:
    the profiler's host-side tracing lengthens it. `step` runs one step
    (default: the trainer's first training batch)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if step is None:
        chunk, mask, _ = trainer.epoch_batches(trainer.tr_idx, True)[0]

        def step():
            trainer.train_step(chunk, mask)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - s)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(phase, step_device_ms=device_ms, median_step_ms=median_step_ms,
        profiled_step_wall_ms=wall_ms,
        device_idle_share=max(0.0, 1.0 - device_ms / median_step_ms))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:rows]:
        log(phase, kernel=json.dumps(e.key[:90]), calls=e.count,
            device_ms=e.self_device_time_total / 1e3)
    return device_ms


def profile_request(pred, recs, phase, label, rows=4):
    """Device time of one request by kernel (torch.profiler) beside its wall
    time (the profiler's host tracing lengthens the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s = time.perf_counter()
        pred.predict(recs)
        wall_ms = 1e3 * (time.perf_counter() - s)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:rows]
    log(phase, profile=label, request=len(recs), profiled_wall_ms=wall_ms,
        device_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
        top_kernels=json.dumps([[e.key[:70], e.count, e.self_device_time_total / 1e3]
                                for e in top], ensure_ascii=False))


def _reset_counts():
    from ultrafnd_git_tpu_torch.kernels import adamw as aw, flash_attention as fa

    fa.launches = fa.bf16_launches = fa.bf16_causal_launches = 0
    fa.bwd_launches = fa.bwd_bf16_launches = aw.launches = 0


def phase_lm_rung(dev):
    """The text ladder's language-model rung at LFM2-8B-A1B's published
    widths (portbench's configuration, weights from a seed, one flat draw
    on the card): one request of 64 records' fields (portbench's traffic)
    through `DeviceLfm2Encoder.encode_ids`, K2-bf16's causal mode counted,
    timed; then again with every causal attention call and expert product
    held against its plain version on the same operands
    (`lfm2.held_to_plain`), and its peak memory."""
    import torch

    from portbench import traffic, weights
    from portbench.flops import lfm2_8b_a1b as lm_flops
    from portbench.reference import lfm2_encoder as ref
    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
    from ultrafnd_git_tpu_torch.models import bert, lfm2

    cfg = json.loads((REPO / "portbench" / "configs" / "lfm2_8b_a1b.json").read_text())
    spec = json.loads((REPO / "portbench" / "traffic" / "encode_fields_r64.json").read_text())
    lad = cfg["ladder"]
    torch.cuda.reset_peak_memory_stats(dev)
    drawn = weights.draw(ref.param_spec(cfg), 22, dev)["lm"]
    enc = lfm2.DeviceLfm2Encoder(drawn, None, cfg, dim=lad["dim"], max_length=lad["max_length"],
                                 batch_size=lad["batch_size"], device=str(dev))
    del drawn
    torch.cuda.empty_cache()
    r = traffic.make_requests(dict(spec, pool=2), cfg, 22)[0]
    enc.encode_ids(r["ids"], r["mask"])  # builds K2-bf16 and warms the shapes
    before = bert.encode_chunks
    torch.cuda.synchronize()
    _reset_counts()  # this request only
    t0 = time.perf_counter()
    got = enc.encode_ids(r["ids"], r["mask"])
    ms = 1e3 * (time.perf_counter() - t0)
    chunks = bert.encode_chunks - before
    attn = sum(t == "full_attention" for t in cfg["layer_types"])
    launched = (fa.bf16_causal_launches, fa.bf16_launches)
    if launched != (attn * chunks, 0):
        raise RuntimeError(f"LM rung: K2-bf16 causal / plain launches {launched}, "
                           f"expected ({attn * chunks}, 0)")
    gaps = lfm2.held_to_plain(enc.module)
    again = enc.encode_ids(r["ids"], r["mask"])
    peak = torch.cuda.max_memory_allocated(dev)
    log("lm_rung", strings=len(r["lengths"]), tokens=int(r["lengths"].sum()), chunks=chunks,
        request_ms=ms, tflops=lm_flops.real_flops(cfg, r["lengths"]) / ms / 1e9,
        causal_launches=launched[0], attention_gap=gaps["attention"],
        experts_gap=gaps["experts"], bit_identical_repeat=bool(np.array_equal(got, again)),
        peak_gib=peak / 2 ** 30, products="grouped" if hasattr(torch, "_grouped_mm") else "loop")
    if not (gaps["attention"] <= 8e-3 and gaps["experts"] <= 1e-2):
        raise RuntimeError(f"LM rung: the card's path against the plain one on the same "
                           f"operands: {gaps}")
    del enc
    torch.cuda.empty_cache()
    return {"launches": {"fwd_bf16_causal": launched[0]}}


def phase_train(dev, model_dir, out_dir, sparse_graph=False, bf16=False, f32_step_ms=None):
    """fit() one epoch and test() on the card, launches counted; the profile
    of a step (dense runs); the GPU-vs-CPU gradient. `bf16` is the
    `--bf16` (bf16_compute) run. Returns {launches, median_step_ms}."""
    import torch

    from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer

    phase = "sparse" if sparse_graph else ("bf16_train" if bf16 else "train")
    t0 = time.perf_counter()
    trainer = ForensicTrainer(_train_cfg(out_dir, model_dir, sparse_graph, bf16), device="cuda")
    if sparse_graph and ("a_norm" in trainer.corpus or "nbr_idx" not in trainer.corpus):
        raise RuntimeError("the --sparse_graph trainer did not build the neighbour lists alone")
    log(phase, init_s=time.perf_counter() - t0, corpus=trainer.n_total,
        train_rows=len(trainer.tr_idx), val_rows=len(trainer.va_idx),
        test_rows=len(trainer.te_idx), batch=TRAIN_BATCH,
        **({"neighbour_slots": int(trainer.corpus["nbr_idx"].shape[1])} if sparse_graph else {}))
    step_ms = []
    train_step = trainer.train_step

    def timed_step(idx, mask):
        torch.cuda.synchronize()
        s = time.perf_counter()
        out = train_step(idx, mask)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - s))
        return out

    trainer.train_step = timed_step
    _reset_counts()  # this path's run only
    t1 = time.perf_counter()
    trainer.fit()
    results = trainer.test()
    fit_test_s = time.perf_counter() - t1
    launches = _launch_counts()
    trainer.train_step = train_step

    steps = len(step_ms)
    chunks = sum(-(-len(s) // TRAIN_BATCH) for s in (trainer.va_idx, trainer.te_idx))
    depth = TOWER["depth"]
    fwd, bwd = depth * (steps + chunks), depth * steps
    expect = {"fwd": 0 if bf16 else fwd, "fwd_bf16": fwd if bf16 else 0,
              "bwd": 0 if bf16 else bwd, "bwd_bf16": bwd if bf16 else 0, "adamw": steps}
    if steps != -(-len(trainer.tr_idx) // TRAIN_BATCH) or launches != expect:
        raise RuntimeError(f"launches {launches} over {steps} steps, expected {expect}")
    log_rows = [json.loads(ln) for ln in (Path(out_dir) / "metrics.jsonl").read_text().splitlines()]
    losses = [r[k] for r in log_rows for k in ("train_loss", "val_loss")] + [results["test_loss"]]
    if not np.isfinite(losses).all() or not all(np.isfinite(v) for v in results.values()):
        raise RuntimeError(f"non-finite losses or metrics: {losses} {results}")
    for slot in ("best", "latest"):
        if not (Path(out_dir) / slot / "meta.json").exists():
            raise RuntimeError(f"fit() wrote no {slot} slot")
    later = step_ms[1:]
    median_step = statistics.median(later)
    log(phase, steps=steps, launches=json.dumps(launches, separators=(",", ":")),
        expected=json.dumps(expect, separators=(",", ":")),
        first_step_ms=step_ms[0], median_step_ms=median_step,
        samples_per_s=TRAIN_BATCH * 1e3 / median_step,
        fit_and_test_s=fit_test_s, losses=json.dumps([round(x, 6) for x in losses]),
        test_auc=results["test_auc"],
        **({"f32_median_step_ms": f32_step_ms,
            "f32_samples_per_s": TRAIN_BATCH * 1e3 / f32_step_ms} if f32_step_ms else {}))

    if not sparse_graph:
        profile_step(trainer, median_step)

    t2 = time.perf_counter()
    cfg = _train_cfg(Path(out_dir).parent / f"cpu_{phase}", model_dir, sparse_graph, bf16)
    cfg.cache_to_disk = False
    cpu = ForensicTrainer(cfg, cache=trainer.cache, device="cpu")
    for part, mod in cpu.state.params.items():
        mod.load_state_dict({k: v.cpu() for k, v in trainer.state.params[part].state_dict().items()})
    rows = TRAIN_BATCH if bf16 else 64
    (rel, leaf), (l2, l2_leaf) = _grad_gap(trainer, cpu, rows)
    bounds = (BF16_GRAD_MAX, BF16_GRAD_L2) if bf16 else (GRAD_RTOL, float("inf"))
    if not (rel <= bounds[0] and l2 <= bounds[1]):
        raise RuntimeError(f"GPU vs CPU-plain gradient: {leaf} differs by {rel} of its max, "
                           f"{l2_leaf} by {l2} in L2 (bounds {bounds})")
    log(phase, gpu_vs_cpu_grad_max_rel=rel, worst_leaf=leaf, gpu_vs_cpu_grad_l2_rel=l2,
        worst_l2_leaf=l2_leaf, bounds=json.dumps(bounds), rows=rows,
        check_s=time.perf_counter() - t2)
    return {"launches": launches, "median_step_ms": median_step}


def phase_bf16_serve(model_dir, requests):
    """The bf16_compute model's best slot, exported, answers one request
    through Predictor(bf16=True): finite rows, K2-bf16 launches only."""
    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
    from ultrafnd_git_tpu_torch.serving import Predictor

    pred = Predictor(model_dir, device="cuda", bf16=True)
    try:
        _reset_counts()  # this check's run only
        rows = pred.predict(requests[1])
        launches = {"fwd": fa.launches, "fwd_bf16": fa.bf16_launches}
    finally:
        pred.close()
    p = np.array([r["prob_fake"] for r in rows])
    if len(rows) != len(requests[1]) or not np.isfinite(p).all() or launches["fwd"] \
            or launches["fwd_bf16"] != TOWER["depth"]:
        raise RuntimeError(f"bf16 serving of the bf16_compute model: launches {launches}, "
                           f"prob_fake {p[:4]}")
    log("bf16_train", served_request=len(rows), launches=json.dumps(launches),
        prob_min=float(p.min()), prob_max=float(p.max()))


def _timed_requests(pred, requests):
    """Each request REPEATS times: (the last rows of each, median seconds of each)."""
    rows, lat = [], []
    for recs in requests:
        times = []
        for _ in range(REPEATS):
            s = time.perf_counter()
            out = pred.predict(recs)  # returns host floats: synchronised
            times.append(time.perf_counter() - s)
        rows.append(out)
        lat.append(statistics.median(times))
    return rows, lat


def _values(rows_by_request, key="prob_fake"):
    return np.concatenate([[r[key] for r in out] for out in rows_by_request])


def phase_serve(model_dir, requests):
    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
    from ultrafnd_git_tpu_torch.serving import FORENSIC_KEYS, Predictor

    t1 = time.perf_counter()
    gpu = Predictor(model_dir, device="cuda")
    gpu.warmup(max(REQUEST_SIZES))  # every bucket the requests use
    log("serve", predictor_init_and_warmup_s=time.perf_counter() - t1, corpus=N_CORPUS)
    try:
        _reset_counts()  # this path's run only
        rows, lat = _timed_requests(gpu, requests)
        launches = fa.launches
        if fa.bwd_launches or fa.bf16_launches or fa.bwd_bf16_launches:
            raise RuntimeError("f32 serving launched the backward or the bf16 kernel")
        profile_request(gpu, requests[-1], "serve", "f32")
    finally:
        gpu.close()
    chunks = len(REQUEST_SIZES) * REPEATS  # a request is one GPU chunk (<= 4096 rows)
    expect = TOWER["depth"] * chunks
    if launches != expect:
        raise RuntimeError(f"flash kernel launched {launches} times, expected {expect}")
    for recs, out in zip(requests, rows):
        p = np.array([r["prob_fake"] for r in out])
        if len(out) != len(recs) or not (np.isfinite(p).all() and (p >= 0).all()
                                          and (p <= 1).all()):
            raise RuntimeError("bad prob_fake values in a GPU response")
        if [r["id"] for r in out] != [r["video_id"] for r in recs]:
            raise RuntimeError("response ids do not match the request")
    for n, t in zip(REQUEST_SIZES, lat):
        log("serve", request=n, median_latency_ms=1e3 * t, records_per_s=n / t,
            repeats=REPEATS)

    cpu = Predictor(model_dir, device="cpu")
    try:
        cpu_rows = [cpu.predict(recs) for recs in requests]
    finally:
        cpu.close()
    diffs = {}
    for key in ("prob_fake", *FORENSIC_KEYS):
        diffs[key] = float(np.max(np.abs(_values(rows, key) - _values(cpu_rows, key))))
        if not diffs[key] <= PROB_ATOL:
            raise RuntimeError(f"GPU vs CPU-plain {key} differ by {diffs[key]}")
    all_p = _values(rows)
    log("serve", launches=launches, expected=expect,
        gpu_vs_cpu_max_abs=json.dumps(diffs, separators=(",", ":")),
        prob_min=float(all_p.min()), prob_max=float(all_p.max()),
        prob_std=float(all_p.std()))
    return {"launches": launches, "rows": rows, "latency_s": lat, "cpu_rows": cpu_rows}


def phase_serve_levers(model_dir, requests, f32):
    """The requests through bf16, int8 and both: which K2 mode ran, the gap to
    the f32 rows and to each lever's own CPU run, median latencies."""
    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
    from ultrafnd_git_tpu_torch.serving import Predictor

    expect = TOWER["depth"] * len(REQUEST_SIZES) * REPEATS
    total = {"fwd": 0, "fwd_bf16": 0}
    for levers in LEVERS:
        name = "+".join(levers)
        t0 = time.perf_counter()
        gpu = Predictor(model_dir, device="cuda", **levers)
        gpu.warmup(max(REQUEST_SIZES))
        init_s = time.perf_counter() - t0
        try:
            _reset_counts()  # this path's run only
            rows, lat = _timed_requests(gpu, requests)
            launches = {"fwd": fa.launches, "fwd_bf16": fa.bf16_launches}
            profile_request(gpu, requests[-1], "serve_levers", name)
        finally:
            gpu.close()
        bf16 = bool(levers.get("bf16"))
        want = {"fwd": 0 if bf16 else expect, "fwd_bf16": expect if bf16 else 0}
        if launches != want or fa.bwd_launches or fa.bwd_bf16_launches:
            raise RuntimeError(f"{name}: launches {launches}, expected {want}")
        for k in total:
            total[k] += launches[k]
        cpu = Predictor(model_dir, device="cpu", **levers)
        try:
            cpu_rows = [cpu.predict(recs) for recs in requests]
        finally:
            cpu.close()
        p, p32, pc = _values(rows), _values(f32["rows"]), _values(cpu_rows)
        vs_f32, vs_cpu = float(np.abs(p - p32).max()), float(np.abs(p - pc).max())
        labels = float(np.mean((p >= 0.5) == (p32 >= 0.5)))
        cpu_tol = LEVER_VS_CPU if bf16 else PROB_ATOL
        if not (np.isfinite(p).all() and vs_f32 <= LEVER_VS_F32 and labels >= LEVER_LABELS
                and vs_cpu <= cpu_tol):
            raise RuntimeError(f"{name}: vs f32 {vs_f32}, labels {labels}, vs its CPU run "
                               f"{vs_cpu} (limit {cpu_tol})")
        log("serve_levers", levers=name, launches=json.dumps(launches, separators=(",", ":")),
            init_and_warmup_s=init_s, max_abs_vs_f32=vs_f32, labels_agree=labels,
            max_abs_vs_own_cpu=vs_cpu,
            median_latency_ms=json.dumps({n: round(1e3 * t, 3) for n, t in
                                          zip(REQUEST_SIZES, lat)}),
            f32_median_latency_ms=json.dumps({n: round(1e3 * t, 3) for n, t in
                                              zip(REQUEST_SIZES, f32["latency_s"])}))
    return total


def phase_explain(model_dir, records):
    """explain() by grad (against the CPU Predictor) and by shap (the
    efficiency axiom), on the card."""
    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
    from ultrafnd_git_tpu_torch.serving import Predictor

    gpu = Predictor(model_dir, device="cuda")
    cpu = Predictor(model_dir, device="cpu")
    try:
        gpu.warmup(len(records))
        _reset_counts()  # this path's run only
        t0 = time.perf_counter()
        grad = gpu.explain(records, method="grad", top_k=512)
        grad_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        shap = gpu.explain(records, method="shap", top_k=8)
        shap_s = time.perf_counter() - t0
        launches = fa.launches
        ref = cpu.explain(records, method="grad", top_k=512)
    finally:
        gpu.close()
        cpu.close()

    def vector(row):
        e = row["explain"]
        v = np.zeros(514)
        for d, x in e["top_fused_dims"]:
            v[d] = x
        v[512:] = e["aux"]["temporal_delay"], e["aux"]["emotion"]
        return v

    g, r = np.stack([vector(x) for x in grad]), np.stack([vector(x) for x in ref])
    grad_rel = float(np.abs(g - r).max() / max(np.abs(r).max(), 1e-30))
    axiom = max(abs(x["explain"]["base_value"] + x["explain"]["fused_signed_sum"]
                    + x["explain"]["aux"]["temporal_delay"] + x["explain"]["aux"]["emotion"]
                    - x["prob_fake"]) for x in shap)
    methods = {x["explain"]["method"] for x in shap} | {x["explain"]["method"] for x in grad}
    if methods != {"kernel-shap", "grad_x_input"} or not grad_rel <= PROB_ATOL \
            or not axiom <= 1e-5 or not launches:
        raise RuntimeError(f"explain: methods {methods}, grad vs CPU {grad_rel} of its "
                           f"largest, axiom {axiom}, K2 launches {launches}")
    log("explain", records=len(records), grad_s=grad_s, shap_s=shap_s, shap_method="kernel-shap",
        grad_vs_cpu_rel=grad_rel, shap_efficiency_max_abs=axiom, launches=launches)
    return launches


# The HTTP clients: a process of their own (its own interpreter lock), one
# thread per client, each sending its records one request at a time.
# argv: url, clients, requests per client; stdin: the records (JSON);
# stdout: {"rows", "latency_s", "wall_s"} (JSON).
HTTP_CLIENT = r"""
import json, sys, threading, time, urllib.request
url, clients, per = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
recs = json.load(sys.stdin)
rows, lat = [None] * len(recs), [0.0] * len(recs)
def client(c):
    for i in range(c * per, (c + 1) * per):
        req = urllib.request.Request(url + "/predict", data=json.dumps({"records": [recs[i]]}).encode(),
                                     headers={"Content-Type": "application/json"})
        s = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as resp:
            [rows[i]] = json.loads(resp.read())["predictions"]
        lat[i] = time.perf_counter() - s
t0 = time.perf_counter()
threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=300)
print(json.dumps({"rows": rows, "latency_s": lat, "wall_s": time.perf_counter() - t0}))
"""


def phase_http(model_dir, requests, corpus):
    """The HTTP server over the f32 GPU Predictor: 16 clients x 8 one-record
    requests from another process, then one 300-record request and one
    /explain."""
    import threading
    import urllib.request

    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
    from ultrafnd_git_tpu_torch.server import make_server
    from ultrafnd_git_tpu_torch.serving import Predictor

    pred = Predictor(model_dir, device="cuda")
    pred.warmup(max(REQUEST_SIZES))
    server = make_server(pred, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(url + path, data=json.dumps(payload).encode("utf-8"),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    singles = synthetic_records(HTTP_CLIENTS * HTTP_PER_CLIENT, corpus, np.random.default_rng(5))
    try:
        _reset_counts()  # this path's run only
        proc = subprocess.run(
            [sys.executable, "-c", HTTP_CLIENT, url, str(HTTP_CLIENTS), str(HTTP_PER_CLIENT)],
            input=json.dumps(singles, ensure_ascii=False), capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"the HTTP client process failed:\n{proc.stderr[-3000:]}")
        clients = json.loads(proc.stdout.strip().splitlines()[-1])
        big = post("/predict", {"records": requests[-1]})["predictions"]
        expl = post("/explain", {"records": requests[0][:1], "top_k": 4})["predictions"]
        with urllib.request.urlopen(url + "/stats", timeout=30) as resp:
            stats = json.loads(resp.read())
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        launches = fa.launches
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        thread.join(timeout=5)
    direct, direct_big = pred.predict(singles), pred.predict(requests[-1])
    pred.close()
    got, lat = clients["rows"], clients["latency_s"]
    if any(r is None for r in got):
        raise RuntimeError("an HTTP client got no row")
    gap = max(abs(a["prob_fake"] - b["prob_fake"]) for a, b in zip(got + big, direct + direct_big))
    ids_ok = [r["id"] for r in got + big] == [r["id"] for r in direct + direct_big]
    b = stats["batcher"]
    n_requests = len(singles) + 1
    if not (ids_ok and gap <= 1e-5 and b["dispatches"] < n_requests
            and expl[0]["explain"]["method"] == "grad_x_input" and health["backend"] == "cuda"):
        raise RuntimeError(f"http: ids {ids_ok}, gap {gap}, dispatches {b['dispatches']} for "
                           f"{n_requests} requests, health {health}")
    log("http", clients=HTTP_CLIENTS, requests_per_client=HTTP_PER_CLIENT,
        client_process="separate", p50_ms=1e3 * float(np.percentile(lat, 50)),
        p99_ms=1e3 * float(np.percentile(lat, 99)),
        records_per_s=len(singles) / clients["wall_s"], dispatches=b["dispatches"],
        requests=n_requests, records_per_dispatch=b["avg_records_per_dispatch"],
        max_abs_vs_direct=gap, launches=launches, device_name=json.dumps(health["device_name"]))
    return launches


def phase_sparse_serve(model_dir, requests):
    """A --sparse_graph model through both graph layouts."""
    from ultrafnd_git_tpu_torch.serving import FORENSIC_KEYS, Predictor

    rows = {}
    for layout in (None, False):
        pred = Predictor(model_dir, device="cuda", sparse_graph=layout)
        try:
            if pred.sparse_graph is not (layout is None):
                raise RuntimeError("the sparse checkpoint did not serve sparse by default")
            rows[layout] = [pred.predict(recs) for recs in requests]
        finally:
            pred.close()
    gap = max(float(np.abs(_values(rows[None], k) - _values(rows[False], k)).max())
              for k in ("prob_fake", *FORENSIC_KEYS))
    if not gap <= 1e-5:
        raise RuntimeError(f"sparse vs dense layout serving differ by {gap}")
    log("sparse", served_layouts="sparse,dense", max_abs_between_layouts=gap,
        records=sum(len(r) for r in requests))


class _Tee:
    """stdout that is also kept: what the port's entry points print."""

    def __init__(self, stream):
        self.stream, self.text = stream, []

    def write(self, s):
        self.text.append(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def raw_records(count, rng, prefix):
    """FakeSV records: Chinese titles and comments from CJK_WORDS, with some
    terms of the emotion lexicon (more of them in the fake half), and OCR
    from RAW_TOPICS topics of 10 tokens: two records of one topic share
    tokens, so the Jaccard graph at 0.12 has edges. Labels alternate
    假 / 辟谣 (balanced)."""
    from ultrafnd_git_tpu_torch.models.affective import EMO_LEXICON

    emo = {h: sorted(EMO_LEXICON[h]) for h in ("fear", "anger", "joy")}
    recs = []
    for i in range(count):
        fake = i % 2 == 0
        words = list(rng.choice(CJK_WORDS, size=int(rng.integers(2, 9))))
        for head, p in (("fear", 0.5 if fake else 0.15), ("anger", 0.4 if fake else 0.1),
                        ("joy", 0.1 if fake else 0.5)):
            if rng.uniform() < p:
                words.append(str(rng.choice(emo[head])))
        topic = int(rng.integers(RAW_TOPICS))
        ocr = [f"话题{topic:03d}词{j}" for j in rng.choice(10, size=4, replace=False)]
        ocr.append(str(rng.choice(CJK_WORDS)))
        recs.append({
            "video_id": f"{prefix}_{i:05d}",
            "title": " ".join(words),
            "ocr": " ".join(ocr) if i % 10 else "",
            "comments": [str(c) for c in rng.choice(CJK_WORDS, size=int(rng.integers(0, 4)))],
            "annotation": "假" if fake else "辟谣",
        })
    return recs


def write_raw_root(root, n, rng):
    """A synthetic FakeSV data root: data_complete.json with n records."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "data_complete.json", "w", encoding="utf-8") as fh:
        json.dump(raw_records(n, rng, "raw"), fh, ensure_ascii=False)
    return root


def _launch_counts():
    from ultrafnd_git_tpu_torch.kernels import adamw as aw, flash_attention as fa

    return {"fwd": fa.launches, "fwd_bf16": fa.bf16_launches, "bwd": fa.bwd_launches,
            "bwd_bf16": fa.bwd_bf16_launches, "adamw": aw.launches}


def _run_cli(main, argv):
    """A CLI's main() in this process (the kernel counts see it): (what it
    returned, what it printed)."""
    from contextlib import redirect_stdout

    tee = _Tee(sys.stdout)
    with redirect_stdout(tee):
        results = main(argv)
    return results, "".join(tee.text)


def _train_cli(argv):
    from ultrafnd_git_tpu_torch.train import main as train_main

    return _run_cli(train_main, argv)


def phase_raw_train(root):
    """The canonical user path from a raw FakeSV data root through the CLI:
    train --data_root R --use_evidence --train_text_tower at full width
    (batch 512, one epoch, seed 0) with --export_model_dir; the cache built
    on the card against a CPU build; launches; a second run under
    --eval_only reuses the cache."""
    import torch

    from ultrafnd_git_tpu_torch.data import cache as cache_mod
    from ultrafnd_git_tpu_torch.data.dataset import FakeSVRawDataset
    from ultrafnd_git_tpu_torch.ops.jaccard import build_edges_from_ocr
    from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer

    t0 = time.perf_counter()
    data_root = write_raw_root(root / "fakesv_raw", N_CORPUS, np.random.default_rng(2))
    out, exported = root / "raw_run", root / "raw_model"
    log("raw_train", data_root_records=N_CORPUS, write_s=time.perf_counter() - t0)
    argv = ["--data_root", str(data_root), "--out_dir", str(out), "--use_evidence",
            "--train_text_tower", "--batch_size", str(TRAIN_BATCH), "--epochs", "1",
            "--seed", "0"]

    step_ms = []
    train_step = ForensicTrainer.train_step

    def timed_step(self, idx, mask):
        torch.cuda.synchronize()
        s = time.perf_counter()
        result = train_step(self, idx, mask)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - s))
        return result

    ForensicTrainer.train_step = timed_step
    _reset_counts()  # this path's run only
    t1 = time.perf_counter()
    try:
        results, said = _train_cli(argv + ["--export_model_dir", str(exported)])
    finally:
        ForensicTrainer.train_step = train_step
    launches = _launch_counts()
    wall_s = time.perf_counter() - t1
    built = re.search(r"feature cache: built from .* \((\d+) records\): host featurize (\S+) s, "
                      r"align pass (\S+) s on ([^,\s]+), text rung (\S+)", said)
    if built is None or int(built.group(1)) != N_CORPUS or not built.group(4).startswith("cuda") \
            or built.group(5) != "hash":
        raise RuntimeError(f"the run did not build its cache from the data root on the card: "
                           f"{built and built.group(0)}")

    cache = cache_mod.load_cache(str(out / "feature_cache.npz"))
    tr, va, te = (len(s) for s in cache["split"])
    steps = len(step_ms)
    chunks = -(-va // TRAIN_BATCH) + -(-te // TRAIN_BATCH)
    depth = TOWER["depth"]
    # K1 also runs the GCN warm start's two AdamW updates in the trainer's init
    expect = {"fwd": depth * (steps + chunks), "fwd_bf16": 0, "bwd": depth * steps,
              "bwd_bf16": 0, "adamw": steps + 2}
    if steps != -(-tr // TRAIN_BATCH) or launches != expect:
        raise RuntimeError(f"raw_train launches {launches} over {steps} steps, expected {expect}")
    rows = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
    losses = [r[k] for r in rows for k in ("train_loss", "val_loss")] + [results["test_loss"]]
    if not np.isfinite(losses).all() or not all(np.isfinite(v) for v in results.values()):
        raise RuntimeError(f"raw_train: non-finite losses or metrics: {losses} {results}")

    # the card's build against a CPU build from the same seed (TF32 off)
    t2 = time.perf_counter()
    cpu = cache_mod.build_feature_cache(FakeSVRawDataset(str(data_root)), seed=0,
                                        encoders=cache_mod.make_encoders(seed=0, device="cpu"))
    cpu_build_s = time.perf_counter() - t2
    exact = ["labels", "text", "audio", "visual", "text_ids", "text_mask"]
    bad = [k for k in exact if not np.array_equal(cache[k], cpu[k])]
    bad += [k for k, a, b in (("evidence[:, :2]", cache["evidence"][:, :2], cpu["evidence"][:, :2]),
                              ("aux[:, 1]", cache["aux"][:, 1], cpu["aux"][:, 1]))
            if not np.array_equal(a, b)]
    bad += [k for k in ("ocr_sets", "ids") if list(cache[k]) != list(cpu[k])]
    bad += [f"split[{i}]" for i in range(3) if not np.array_equal(cache["split"][i], cpu["split"][i])]
    rel = {k: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)) for k, a, b in (
        ("temporal", cache["temporal"], cpu["temporal"]),
        ("aux[:, 0]", cache["aux"][:, 0], cpu["aux"][:, 0]),
        ("evidence[:, 2]", cache["evidence"][:, 2], cpu["evidence"][:, 2]))}
    if bad or max(rel.values()) > CACHE_REL:
        raise RuntimeError(f"the card's cache differs from the CPU build: host keys {bad}, "
                           f"align keys {rel} of their largest (bound {CACHE_REL})")
    ev = cache["evidence"]
    if not (ev.std(axis=0) > 0).all():
        raise RuntimeError(f"an evidence column is constant: std {ev.std(axis=0)}")
    src, _, _ = build_edges_from_ocr(cache["ocr_sets"], 0.12)
    edges = len(src) // 2
    if not edges:
        raise RuntimeError("the raw corpus's Jaccard graph has no edge")
    later = step_ms[1:]
    median_step = statistics.median(later)
    log("raw_train", records=N_CORPUS, train_rows=tr, val_rows=va, test_rows=te,
        cache_host_featurize_s=float(built.group(2)), cache_align_pass_s=float(built.group(3)),
        align_device=built.group(4), cpu_cache_build_s=cpu_build_s,
        gpu_vs_cpu_cache=json.dumps(rel, separators=(",", ":")), host_keys_equal=True,
        evidence_mean=json.dumps(ev.mean(axis=0).tolist()),
        evidence_std=json.dumps(ev.std(axis=0).tolist()), graph_edges=edges,
        steps=steps, launches=json.dumps(launches, separators=(",", ":")),
        expected=json.dumps(expect, separators=(",", ":")), first_step_ms=step_ms[0],
        median_step_ms=median_step, samples_per_s=TRAIN_BATCH * 1e3 / median_step,
        cli_wall_s=wall_s, losses=json.dumps([round(x, 6) for x in losses]),
        test=json.dumps({k: round(v, 6) for k, v in results.items()}))

    # --eval_only on the same out_dir: the cache is reused, not rebuilt
    npz = out / "feature_cache.npz"
    stamp = npz.stat().st_mtime_ns
    _reset_counts()
    _, said = _train_cli(argv + ["--eval_only"])
    eval_launches = _launch_counts()
    eval_expect = {"fwd": depth * -(-te // TRAIN_BATCH), "fwd_bf16": 0, "bwd": 0, "bwd_bf16": 0,
                   "adamw": 0}
    if "feature cache: reusing" not in said or "feature cache: built" in said \
            or npz.stat().st_mtime_ns != stamp or eval_launches != eval_expect:
        raise RuntimeError(f"--eval_only rebuilt the cache or launched {eval_launches} "
                           f"(expected {eval_expect})")
    log("raw_train", eval_only="reused the cache", launches=json.dumps(eval_launches))
    return {"launches": launches, "median_step_ms": median_step, "data_root": data_root,
            "exported": exported, "out_dir": out, "train_rows": cache["split"][0]}


def phase_reference_migration(root, raw, requests):
    """A reference best.pt through the port: run/best exported (heads only),
    imported over the raw data root on the raw run's cache, served on the
    card against the CPU, fine-tuned one epoch by train --resume with every
    K1 update held to the plain one, exported again and held to its slot.
    Returns the path's launch counts."""
    import torch

    from ultrafnd_git_tpu_torch import export_reference, import_reference
    from ultrafnd_git_tpu_torch.kernels import adamw as aw
    from ultrafnd_git_tpu_torch.serving import Predictor
    from ultrafnd_git_tpu_torch.training.checkpoint import read_slot

    t0 = time.perf_counter()
    mig = root / "migration"
    best_pt, imported = mig / "reference" / "best.pt", mig / "imported"
    rc, said = _run_cli(export_reference.main, ["--out_dir", str(root / "run"),
                                                "--dest", str(best_pt)])
    if rc != 0 or "warning: checkpoint carries a trained text tower" not in said:
        raise RuntimeError(f"reference_migration: export of run/best returned {rc}")
    payload = torch.load(best_pt, weights_only=True)
    export_s = time.perf_counter() - t0
    # the raw run's cache and align weights: the import's fingerprint is theirs
    imported.mkdir(parents=True)
    for name in ("feature_cache.npz", "align.pt"):
        shutil.copyfile(raw["out_dir"] / name, imported / name)

    # every K1 update of the import and the resume (this model's leaf set:
    # the heads, no tower) bit for bit against the plain update on a copy of
    # its own inputs; the copies' updates run the plain version, no launch
    apply, update = aw.FusedAdamW.apply, aw.FusedAdamW._update
    held = {"updates": 0, "max_abs_err": 0.0, "leaves": 0, "params": 0}

    def named_apply(self, params, state, grads):
        held["names"] = [f"{part}.{n}" for part, mod in params.items()
                         if part not in self.frozen for n, _ in mod.named_parameters()]
        return apply(self, params, state, grads)

    def held_update(self, leaves, scal):
        plain = [tuple(t.clone() for t in leaf) for leaf in leaves]
        for leaf in plain:
            aw.adamw_reference_(*leaf, scal)
        update(self, leaves, scal)
        for name, got, want in zip(held["names"], leaves, plain, strict=True):
            for t, x, y in zip("pmv", got, want):
                if not torch.equal(x, y):
                    raise RuntimeError(f"reference_migration: K1 differs from the plain update "
                                       f"at {name} ({t}) in update {held['updates']}")
                held["max_abs_err"] = max(held["max_abs_err"], _max_err(x, y))
        held["updates"] += 1
        held["leaves"], held["params"] = len(leaves), sum(leaf[0].numel() for leaf in leaves)
        held["last"] = {name: want[0] for name, want in zip(held["names"], plain)}

    aw.FusedAdamW.apply, aw.FusedAdamW._update = named_apply, held_update
    try:
        _reset_counts()  # this path's run only
        t1 = time.perf_counter()
        rc, said = _run_cli(import_reference.main, [str(best_pt), "--data_root",
                                                    str(raw["data_root"]), "--out_dir",
                                                    str(imported)])
        import_s = time.perf_counter() - t1
        if rc != 0 or "feature cache: reusing" not in said or "(fusion+clf+gnn)" not in said:
            raise RuntimeError(f"reference_migration: the import returned {rc} or rebuilt the "
                               "cache")

        t2 = time.perf_counter()
        served = {}
        for dev in ("cuda", "cpu"):
            pred = Predictor(out_dir=str(imported), device=dev)
            served[dev] = [pred.predict(r) for r in requests]
            pred.close()
        serve_s = time.perf_counter() - t2
        gap = _max_gap(served["cuda"], served["cpu"])
        probs = _values(served["cuda"])
        if gap > PROB_ATOL or len(probs) != sum(REQUEST_SIZES) or not np.isfinite(probs).all():
            raise RuntimeError(f"reference_migration: the imported slot on the card differs "
                               f"from the CPU by {gap} (bound {PROB_ATOL}) or is not finite")

        t3 = time.perf_counter()
        results, said = _train_cli(["--data_root", str(raw["data_root"]), "--out_dir",
                                    str(imported), "--resume", "--epochs", "1", "--batch_size",
                                    str(TRAIN_BATCH), "--seed", "0"])
        resume_s = time.perf_counter() - t3
        launches = _launch_counts()
    finally:
        aw.FusedAdamW.apply, aw.FusedAdamW._update = apply, update
    meta = read_slot(str(imported), "latest")[1]
    steps = -(-len(raw["train_rows"]) // TRAIN_BATCH)
    expect = {"fwd": 0, "fwd_bf16": 0, "bwd": 0, "bwd_bf16": 0, "adamw": 2 + 2 + steps}
    if "[Epoch 01]" not in said or "feature cache: reusing" not in said or meta["epoch"] != 1 \
            or launches != expect or not all(np.isfinite(v) for v in results.values()):
        raise RuntimeError(f"reference_migration: --resume did not fine-tune from epoch 1 on "
                           f"the cache, or launched {launches} (expected {expect})")
    # the resumed latest slot is the plain update's output at the last step
    slot = read_slot(str(imported), "latest")[0]["params"]
    last = {tuple(k.split(".", 1)): p.cpu() for k, p in held["last"].items()}
    moved = [k for k, p in last.items() if not torch.equal(slot[k[0]][k[1]], p)]
    if held["updates"] != expect["adamw"] or moved \
            or not {"fusion", "clf"} <= {k[0] for k in last}:
        raise RuntimeError(f"reference_migration: {held['updates']} updates held of "
                           f"{expect['adamw']}, or the latest slot differs from the plain "
                           f"update at {moved[:5]}")

    back = mig / "back.pt"
    rc, _ = _run_cli(export_reference.main, ["--out_dir", str(imported), "--slot", "latest",
                                             "--dest", str(back)])
    file = torch.load(back, weights_only=True)
    semantic = {k for k in file["fusion"] if k.startswith("semantic.")}
    differ = [f"{part}.{k}" for part in ("fusion", "clf", "gnn") for k, v in slot[part].items()
              if not torch.equal(file[part][k], v)]
    if rc != 0 or differ or set(file["fusion"]) != set(slot["fusion"]) | semantic \
            or len(semantic) != 4 or set(file["clf"]) != set(slot["clf"]):
        raise RuntimeError(f"reference_migration: the export differs from its slot: {differ[:5]}")
    log("reference_migration", reference_tensors=json.dumps(
            {k: len(payload[k]) for k in ("fusion", "clf", "gnn")}),
        records=N_CORPUS, steps=steps, launches=json.dumps(launches, separators=(",", ":")),
        k1_updates_held=held["updates"], k1_leaves=held["leaves"], k1_params=held["params"],
        k1_vs_plain_max_abs_err=held["max_abs_err"], k1_bit_identical=True,
        latest_slot_is_plain_output=True, gpu_vs_cpu_max_gap=gap,
        prob_mean=float(np.mean(probs)), export_s=export_s, import_s=import_s,
        serve_s=serve_s, resume_s=resume_s,
        test=json.dumps({k: round(v, 6) for k, v in results.items()}),
        phase_wall_s=time.perf_counter() - t0, script_wall_s=time.perf_counter() - T0)
    return launches


def _fields(rec):
    """The strings the text ladder encodes for a record: title, OCR and up
    to 10 comments, the non-empty ones."""
    return [t for t in [rec.get("title"), rec.get("ocr"), *(rec.get("comments") or [])[:10]] if t]


def phase_text_tower(data_root, out_dir, exported, requests):
    """The text ladder's tower rung on the card. Seeded (ULTRAFND_TEXT_DEVICE=1):
    the feature cache of raw_train's data root built with the text column
    from the seeded 768-wide tower (depth 4, 12 heads of 64, S = 256), K2
    launches = depth x chunks, a profiled chunk, the first records' text
    against a CPU build. Trained (ULTRAFND_TEXT_DEVICE_CKPT = raw_train's
    out_dir): Predictor(out_dir=, checkpoint_name="latest") serves the three
    requests against the CPU Predictor of the slot, beside the hash rung's
    latency; Predictor(out_dir=, "best") against the run's exported model
    directory."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ultrafnd_git_tpu_torch.data import cache as cache_mod
    from ultrafnd_git_tpu_torch.data.dataset import FakeSVRawDataset
    from ultrafnd_git_tpu_torch.models.encoders import (
        TEXT_DEVICE,
        TEXT_DEVICE_CKPT,
        TextFieldEncoder,
        tower_rung,
    )
    from ultrafnd_git_tpu_torch.serving import FORENSIC_KEYS, Predictor

    saved = {k: os.environ.get(k) for k in (TEXT_DEVICE, TEXT_DEVICE_CKPT)}
    preds = []
    try:
        # ---- the seeded rung: the cache build on the card ------------------
        os.environ[TEXT_DEVICE] = "1"
        os.environ.pop(TEXT_DEVICE_CKPT, None)
        raw = FakeSVRawDataset(str(data_root))
        records = [raw.get_item(i) for i in range(len(raw))]
        strings = [t for r in records for t in _fields(r)]
        chunks = -(-len(strings) // TEXT_CHUNK)
        enc = cache_mod.make_encoders(seed=0, device="cuda")
        text = enc["text"]
        tower = text._tower()
        dims = dict(dim=tower.dim, depth=len(tower.tower.blocks),
                    heads=tower.tower.blocks[0].attn.heads, max_len=tower.max_len)
        if dims != SEEDED_RUNG or tower_rung() != "tower-seeded" or tower.device.type != "cuda":
            raise RuntimeError(f"the seeded rung is {dims} ({tower_rung()}) on {tower.device}")
        text_s = []
        fields = text.encode_fields_batch

        def timed_fields(recs):
            t = time.perf_counter()
            out = fields(recs)
            text_s.append(time.perf_counter() - t)  # one copy back a chunk: synchronised
            return out

        text.encode_fields_batch = timed_fields
        seconds = {}
        _reset_counts()  # this path's run only
        t0 = time.perf_counter()
        built = cache_mod.build_feature_cache(raw, seed=0, encoders=enc, timings=seconds)
        build_s = time.perf_counter() - t0
        seeded_launches = _launch_counts()
        expect = {"fwd": SEEDED_RUNG["depth"] * chunks, "fwd_bf16": 0, "bwd": 0, "bwd_bf16": 0,
                  "adamw": 0}
        if seeded_launches != expect:
            raise RuntimeError(f"seeded rung launches {seeded_launches}, expected {expect}")
        t = built["text"]
        norms = np.linalg.norm(t, axis=1)
        if not (np.isfinite(t).all() and np.abs(norms[norms > 0] - 1).max() < 1e-4):
            raise RuntimeError("the seeded rung's text column is not finite and unit-norm")

        # one full chunk: unprofiled wall times, then its device time by kernel
        chunk = strings[:TEXT_CHUNK]
        walls = []
        for _ in range(3):
            s = time.perf_counter()
            tower.encode_batch(chunk)
            walls.append(1e3 * (time.perf_counter() - s))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tower.encode_batch(chunk)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        k2_ms = sum(e.self_device_time_total for e in kernels
                    if "flash" in e.key.lower()) / 1e3
        gemm_ms = sum(e.self_device_time_total for e in kernels
                      if "gemm" in e.key.lower() or "sgemm" in e.key.lower()) / 1e3
        chunk_ms = statistics.median(walls)

        # the first records against a CPU build of the same seeded draw
        t1 = time.perf_counter()
        cpu_text = TextFieldEncoder(device="cpu").encode_fields_batch(records[:TEXT_CHECK_RECORDS])
        cpu_s = time.perf_counter() - t1
        rel = float(np.abs(t[:TEXT_CHECK_RECORDS] - cpu_text).max()
                    / max(np.abs(cpu_text).max(), 1e-30))
        log("text_tower", rung="seeded", **{f"tower_{k}": v for k, v in dims.items()},
            records=len(records), strings=len(strings), chunks=chunks,
            launches=json.dumps(seeded_launches, separators=(",", ":")),
            expected=json.dumps(expect, separators=(",", ":")),
            text_pass_s=text_s[0], cache_build_s=build_s, host_featurize_s=seconds["host_s"],
            align_pass_s=seconds["align_s"], chunk_wall_ms=chunk_ms,
            chunk_device_ms=device_ms, chunk_k2_ms=k2_ms, chunk_gemm_ms=gemm_ms,
            chunk_idle_share=max(0.0, 1.0 - device_ms / chunk_ms),
            cpu_check_records=TEXT_CHECK_RECORDS, cpu_check_s=cpu_s,
            gpu_vs_cpu_text_rel=rel, bound=CACHE_REL)
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            log("text_tower", kernel=json.dumps(e.key[:90]), calls=e.count,
                device_ms=e.self_device_time_total / 1e3)
        if not rel <= CACHE_REL:
            raise RuntimeError(f"seeded rung: the card's text column is {rel} of its largest "
                               f"value from the CPU build (bound {CACHE_REL})")
        del built, enc, text, tower
        torch.cuda.empty_cache()

        # ---- the trained rung: serving raw_train's out_dir -------------------
        os.environ[TEXT_DEVICE] = "0"
        hashed = Predictor(out_dir=str(out_dir), checkpoint_name="latest", device="cuda")
        preds.append(hashed)
        os.environ[TEXT_DEVICE] = "1"
        os.environ[TEXT_DEVICE_CKPT] = str(out_dir)
        rung = tower_rung()
        if rung != f"tower:{Path(out_dir).resolve()}/best":
            raise RuntimeError(f"the trained rung is {rung}")
        gpu = Predictor(out_dir=str(out_dir), checkpoint_name="latest", device="cuda")
        cpu = Predictor(out_dir=str(out_dir), checkpoint_name="latest", device="cpu")
        best = Predictor(out_dir=str(out_dir), checkpoint_name="best", device="cuda")
        model = Predictor(str(exported), device="cuda")
        preds += [gpu, cpu, best, model]
        gpu.warmup(max(REQUEST_SIZES))
        hashed.warmup(max(REQUEST_SIZES))
        _reset_counts()
        rows, lat = _timed_requests(gpu, requests)
        served_launches = _launch_counts()
        trained_depth = len(gpu._encoders["text"]._tower().tower.blocks)
        served_expect = {"fwd": trained_depth * REPEATS * sum(
            -(-sum(len(_fields(r)) for r in recs) // TEXT_CHUNK) + 1 for recs in requests),
            "fwd_bf16": 0, "bwd": 0, "bwd_bf16": 0, "adamw": 0}
        if served_launches != served_expect:
            raise RuntimeError(f"trained rung serving launched {served_launches}, expected "
                               f"{served_expect}")
        hash_rows, hash_lat = _timed_requests(hashed, requests)
        cpu_rows = [cpu.predict(recs) for recs in requests]
        best_rows = [best.predict(recs) for recs in requests]
        model_rows = [model.predict(recs) for recs in requests]
        engaged = not np.allclose(gpu.featurize(requests[0])["text"],
                                  hashed.featurize(requests[0])["text"], atol=1e-3)
    finally:
        for pred in preds:
            pred.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    keys = ("prob_fake", *FORENSIC_KEYS)
    vs_cpu = {k: float(np.max(np.abs(_values(rows, k) - _values(cpu_rows, k)))) for k in keys}
    best_vs_model = {k: float(np.max(np.abs(_values(best_rows, k) - _values(model_rows, k))))
                     for k in keys}
    vs_hash = float(np.max(np.abs(_values(rows) - _values(hash_rows))))
    p = _values(rows)
    log("text_tower", rung=rung, requests=json.dumps([len(x) for x in requests]),
        trained_depth=trained_depth, launches=json.dumps(served_launches, separators=(",", ":")),
        expected=json.dumps(served_expect, separators=(",", ":")),
        median_latency_ms=json.dumps([1e3 * x for x in lat]),
        hash_rung_median_latency_ms=json.dumps([1e3 * x for x in hash_lat]), repeats=REPEATS,
        gpu_vs_cpu_max_abs=json.dumps(vs_cpu, separators=(",", ":")),
        best_vs_exported_max_abs=json.dumps(best_vs_model, separators=(",", ":")),
        prob_vs_hash_rung_max_abs=vs_hash, text_differs_from_hash=engaged)
    if not (max(vs_cpu.values()) <= PROB_ATOL and max(best_vs_model.values()) <= PROB_ATOL):
        raise RuntimeError(f"trained rung serving: GPU vs CPU {vs_cpu}, best slot vs its "
                           f"export {best_vs_model} (bound {PROB_ATOL})")
    if not (engaged and np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all()):
        raise RuntimeError("trained rung serving: the rung did not engage or bad prob_fake")
    return {"launches": {k: seeded_launches[k] + served_launches[k] for k in seeded_launches},
            "strings": len(strings), "chunks": chunks}


def phase_evidence_serve(model_dir, requests):
    """The evidence model exported by raw_train on the card: three requests
    (one chunk each, each sent REPEATS times) and explain(grad) of 8
    records, each against the CPU Predictor; then the 300-record request
    in turns with the same weights served with use_evidence off (the
    fusion's own proxies), its whole latency and its featurize, and the
    two evidence scorers alone; its device time by kernel."""
    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
    from ultrafnd_git_tpu_torch.serving import FORENSIC_KEYS, Predictor

    plain_dir = Path(model_dir).with_name(Path(model_dir).name + "_no_evidence")
    plain_dir.mkdir()
    for name in ("weights.pt", "feature_cache.npz"):
        (plain_dir / name).symlink_to(Path(model_dir) / name)
    meta = json.loads((Path(model_dir) / "meta.json").read_text())
    meta["cfg"]["use_evidence"] = False
    (plain_dir / "meta.json").write_text(json.dumps(meta))
    gpu = Predictor(model_dir, device="cuda")
    plain = Predictor(str(plain_dir), device="cuda")
    cpu = Predictor(model_dir, device="cpu")
    try:
        if not gpu.use_evidence or plain.use_evidence:
            raise RuntimeError("the raw_train export is not an evidence checkpoint")
        gpu.warmup(max(REQUEST_SIZES))
        plain.warmup(max(REQUEST_SIZES))
        _reset_counts()  # this path's run only
        rows, lat = _timed_requests(gpu, requests)
        grad = gpu.explain(requests[0], method="grad", top_k=512)
        launches = fa.launches
        others = fa.bf16_launches + fa.bwd_launches + fa.bwd_bf16_launches
        big = requests[-1]
        # in turns: evidence, none, none, evidence, ...
        turns = {"evidence": {"predict": [], "featurize": []},
                 "no_evidence": {"predict": [], "featurize": []}}
        for i in range(2 * REPEATS):
            order = (("evidence", gpu), ("no_evidence", plain))
            for label, pred in order if i % 2 == 0 else order[::-1]:
                for step, fn in (("predict", pred.predict), ("featurize", pred.featurize)):
                    s = time.perf_counter()
                    fn(big)
                    turns[label][step].append(1e3 * (time.perf_counter() - s))
        scorers_s = []
        for _ in range(REPEATS):
            s = time.perf_counter()
            gpu._encoders["semantic"].gap_magnitude([r["title"] for r in big],
                                                    [r["ocr"] for r in big])
            gpu._encoders["affective"].analyze_batch([r["title"] + " " + r["ocr"] for r in big])
            scorers_s.append(time.perf_counter() - s)
        profile_request(gpu, big, "evidence_serve", "f32")
        cpu_rows = [cpu.predict(recs) for recs in requests]
        ref = cpu.explain(requests[0], method="grad", top_k=512)
    finally:
        gpu.close()
        plain.close()
        cpu.close()
    expect = TOWER["depth"] * (len(requests) * REPEATS + 1)
    if launches != expect or others:
        raise RuntimeError(f"evidence serving: K2 launched {launches} times (expected {expect}), "
                           f"other kernels {others}")
    diffs = {k: float(np.max(np.abs(_values(rows, k) - _values(cpu_rows, k))))
             for k in ("prob_fake", *FORENSIC_KEYS)}
    if not max(diffs.values()) <= PROB_ATOL:
        raise RuntimeError(f"evidence serving, GPU vs CPU: {diffs}")

    def vector(row):
        e = row["explain"]
        v = np.zeros(514)
        for d, x in e["top_fused_dims"]:
            v[d] = x
        v[512:] = e["aux"]["temporal_delay"], e["aux"]["emotion"]
        return v

    g, r = np.stack([vector(x) for x in grad]), np.stack([vector(x) for x in ref])
    grad_rel = float(np.abs(g - r).max() / max(np.abs(r).max(), 1e-30))
    if not grad_rel <= PROB_ATOL:
        raise RuntimeError(f"evidence explain(grad): GPU vs CPU {grad_rel} of the largest")
    p = _values(rows)
    if not (np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all()):
        raise RuntimeError("bad prob_fake values in an evidence response")
    log("evidence_serve", requests=json.dumps([len(x) for x in requests]),
        median_latency_ms=json.dumps([1e3 * t for t in lat]), repeats=REPEATS,
        in_turns_300_median_ms=json.dumps({k: {s: statistics.median(v) for s, v in d.items()}
                                           for k, d in turns.items()}),
        scorers_300_ms=1e3 * statistics.median(scorers_s),
        launches=launches, expected=expect,
        gpu_vs_cpu_max_abs=json.dumps(diffs, separators=(",", ":")),
        explain_grad_vs_cpu_rel=grad_rel, prob_min=float(p.min()), prob_max=float(p.max()),
        semantic_conflict_std=float(_values(rows, "semantic_conflict").std()))
    return launches


def _moe_routes(tower):
    """Forward pre-hooks on a tower's MoE FFNs that record each call's
    (expert, slot) on the host; returns (records, handles)."""
    import torch

    from ultrafnd_git_tpu_torch.models.moe import MoEFFN

    seen, handles = [], []
    for mod in tower.modules():
        if isinstance(mod, MoEFFN):
            def hook(m, args):
                with torch.no_grad():
                    _, _, expert, _, slot = m.route(args[0])
                seen.append((expert.cpu(), slot.cpu()))
            handles.append(mod.register_forward_pre_hook(hook))
    return seen, handles


def _routes_differing(a, b):
    """(tokens sent to another expert, tokens in another slot) between two
    route records. One token sent elsewhere moves the slot of every later
    token of both experts, so the second count is the larger."""
    if len(a) != len(b):
        raise RuntimeError(f"{len(a)} MoE calls against {len(b)}")
    return (sum(int((ea != eb).sum()) for (ea, _), (eb, _) in zip(a, b)),
            sum(int(((ea != eb) | (sa != sb)).sum()) for (ea, sa), (eb, sb) in zip(a, b)))


def _moe_cli(out_dir, model_dir):
    return ["--model_dir", str(model_dir), "--out_dir", str(out_dir), "--train_text_tower",
            "--text_tower_depth", str(TOWER["depth"]), "--text_tower_heads", str(TOWER["heads"]),
            "--moe_experts", str(MOE_EXPERTS), "--batch_size", str(TRAIN_BATCH),
            "--epochs", "1", "--seed", "0", "--fused_adamw"]


def phase_moe_train(model_dir, out_dir, train_step_ms):
    """A switch-MoE tower (8 experts) at full width, one epoch f32 with
    --remat_tower and --profile_dir: launches (K2 twice a block and step
    under remat), the trace, then steps with remat on and off in turns
    (median step, peak device memory), a profiled step, and the dropout-off
    gradient on the GPU against the CPU with every token's route compared."""
    import torch

    from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer

    prof_dir = Path(out_dir).parent / "moe_profile"
    cfg = _train_cfg(out_dir, model_dir)
    cfg.moe_experts, cfg.remat_tower, cfg.profile_dir = MOE_EXPERTS, True, str(prof_dir)
    t0 = time.perf_counter()
    trainer = ForensicTrainer(cfg, device="cuda")
    tower = trainer.state.params["text_tower"]
    if not (tower.remat and tower.moe_experts == MOE_EXPERTS):
        raise RuntimeError("the trainer did not build a remat MoE tower")
    log("moe_train", init_s=time.perf_counter() - t0, experts=MOE_EXPERTS,
        tower_params=sum(p.numel() for p in tower.parameters()),
        capacity=tower.blocks[0].moe.capacity(TRAIN_BATCH * TOWER["max_len"]))
    steps = []
    train_step = trainer.train_step

    def counted_step(idx, mask):
        steps.append(1)
        return train_step(idx, mask)

    trainer.train_step = counted_step
    _reset_counts()  # this path's run only
    t1 = time.perf_counter()
    trainer.fit()
    results = trainer.test()
    fit_test_s = time.perf_counter() - t1
    launches = _launch_counts()
    trainer.train_step = train_step
    n = len(steps)
    chunks = sum(-(-len(s) // TRAIN_BATCH) for s in (trainer.va_idx, trainer.te_idx))
    depth = TOWER["depth"]
    expect = {"fwd": depth * (2 * n + chunks), "fwd_bf16": 0, "bwd": depth * n, "bwd_bf16": 0,
              "adamw": n}
    if n != -(-len(trainer.tr_idx) // TRAIN_BATCH) or launches != expect:
        raise RuntimeError(f"moe_train launches {launches} over {n} steps, expected {expect}")
    rows = [json.loads(ln) for ln in (Path(out_dir) / "metrics.jsonl").read_text().splitlines()]
    losses = [r[k] for r in rows for k in ("train_loss", "val_loss")] + [results["test_loss"]]
    if not np.isfinite(losses).all() or not all(np.isfinite(v) for v in results.values()):
        raise RuntimeError(f"moe_train: non-finite losses or metrics: {losses} {results}")
    trace = prof_dir / "fit.trace.json"
    text = trace.read_text() if trace.exists() else ""
    if "flash_fwd_kernel" not in text or "flash_bwd_kernel" not in text:
        raise RuntimeError(f"the --profile_dir trace {trace} names no K2 / K3+K4 kernel")
    log("moe_train", steps=n, launches=json.dumps(launches, separators=(",", ":")),
        expected=json.dumps(expect, separators=(",", ":")), fit_and_test_s=fit_test_s,
        losses=json.dumps([round(x, 6) for x in losses]), test_auc=results["test_auc"],
        trace_mb=trace.stat().st_size / 1e6)

    # remat on and off in turns on the same trainer: step time and peak memory
    batches = trainer.epoch_batches(trainer.tr_idx, True)
    for mod in trainer.state.params.values():
        mod.train(True)
    timing = {True: [], False: []}
    peak = {True: [], False: []}
    for i in range(2 * MOE_REMAT_TURNS):
        remat = (i % 4) in (0, 3)  # on, off, off, on, ...
        tower.remat = remat
        chunk, mask, _ = batches[i % len(batches)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        s = time.perf_counter()
        trainer.train_step(chunk, mask)
        torch.cuda.synchronize()
        timing[remat].append(1e3 * (time.perf_counter() - s))
        peak[remat].append((torch.cuda.max_memory_allocated(), base))
    tower.remat = True
    med = {k: statistics.median(v[1:]) for k, v in timing.items()}
    gib = 2.0 ** 30
    mem = {k: (max(p for p, _ in v) / gib, max(p - b for p, b in v) / gib)
           for k, v in peak.items()}
    log("moe_train", remat_median_step_ms=med[True], no_remat_median_step_ms=med[False],
        remat_step_ms=json.dumps([round(x, 3) for x in timing[True]]),
        no_remat_step_ms=json.dumps([round(x, 3) for x in timing[False]]),
        remat_samples_per_s=TRAIN_BATCH * 1e3 / med[True],
        dense_f32_median_step_ms=train_step_ms,
        peak_gib_remat=mem[True][0], peak_gib_no_remat=mem[False][0],
        step_peak_over_resident_gib_remat=mem[True][1],
        step_peak_over_resident_gib_no_remat=mem[False][1])
    device_ms = profile_step(trainer, med[True], phase="moe_profile")

    # the dropout-off gradient, GPU against CPU, routes first
    t2 = time.perf_counter()
    cpu_cfg = _train_cfg(Path(out_dir).parent / "cpu_moe", model_dir)
    cpu_cfg.cache_to_disk, cpu_cfg.moe_experts = False, MOE_EXPERTS
    cpu = ForensicTrainer(cpu_cfg, cache=trainer.cache, device="cpu")
    for part, mod in cpu.state.params.items():
        mod.load_state_dict({k: v.cpu() for k, v in trainer.state.params[part].state_dict().items()})
    g_routes, g_hooks = _moe_routes(tower)
    c_routes, c_hooks = _moe_routes(cpu.state.params["text_tower"])
    try:
        (rel, leaf), (l2, l2_leaf) = _grad_gap(trainer, cpu, 64)
    finally:
        for h in g_hooks + c_hooks:
            h.remove()
    # under remat the GPU's recompute routes once more: compare the first pass
    experts, slots = _routes_differing(g_routes[: len(c_routes)], c_routes)
    if slots or not rel <= GRAD_RTOL:
        raise RuntimeError(f"moe_train GPU vs CPU: {experts} tokens to another expert, {slots} "
                           f"in another slot; {leaf} differs by {rel} of its max "
                           f"(bound {GRAD_RTOL})")
    log("moe_train", gpu_vs_cpu_grad_max_rel=rel, worst_leaf=leaf, gpu_vs_cpu_grad_l2_rel=l2,
        worst_l2_leaf=l2_leaf, tokens_to_another_expert=experts, tokens_in_another_slot=slots,
        tokens_compared=sum(int(e.numel()) for e, _ in c_routes), rows=64,
        check_s=time.perf_counter() - t2)
    return {"launches": launches, "median_step_ms": med[True],
            "no_remat_median_step_ms": med[False], "device_ms": device_ms, "memory_gib": mem}


def phase_moe_resume(model_dir, root):
    """The training CLI, MoE tower at full width with --save_every_steps 3,
    killed (SIGKILL, in a process of its own) right after its first
    mid-epoch slot commits, then --resume (in this process, counted): its
    latest slot equals an uninterrupted run's bit for bit."""
    import torch

    whole, cut = Path(root) / "moe_whole", Path(root) / "moe_cut"
    extra = ["--save_every_steps", str(MOE_SAVE_EVERY)]
    t0 = time.perf_counter()
    killed = subprocess.run([sys.executable, "-c", MOE_KILL_WORKER, *_moe_cli(cut, model_dir),
                             *extra], cwd=REPO, capture_output=True, text=True, timeout=900)
    kill_s = time.perf_counter() - t0
    meta = json.loads((cut / "latest" / "meta.json").read_text()) \
        if (cut / "latest" / "meta.json").exists() else {}
    if killed.returncode != -9 or not meta.get("in_epoch") \
            or meta.get("step_cursor") != MOE_SAVE_EVERY:
        raise RuntimeError(f"the killed run ended {killed.returncode} with latest meta "
                           f"{ {k: meta.get(k) for k in ('in_epoch', 'step_cursor')} }: "
                           f"{killed.stderr[-2000:]}")
    _reset_counts()  # this path's run only: the resumed run
    t1 = time.perf_counter()
    _train_cli(_moe_cli(cut, model_dir) + extra + ["--resume"])
    resume_s = time.perf_counter() - t1
    launches = _launch_counts()
    t2 = time.perf_counter()
    _train_cli(_moe_cli(whole, model_dir) + extra)
    whole_s = time.perf_counter() - t2
    a = torch.load(whole / "latest" / "state.pt", weights_only=True)
    b = torch.load(cut / "latest" / "state.pt", weights_only=True)
    bad = [k for k in ("step", "rng") if not torch.equal(a[k], b[k])]
    bad += [f"params.{part}.{k}" for part, sd in a["params"].items() for k, v in sd.items()
            if not torch.equal(v, b["params"][part][k])]
    bad += [f"{key}.{part}.{k}" for key in ("mu", "nu") for part, sd in a["opt_state"][key].items()
            for k, v in sd.items() if not torch.equal(v, b["opt_state"][key][part][k])]
    steps = int(a["step"])
    left = steps - MOE_SAVE_EVERY
    from ultrafnd_git_tpu_torch.data.cache import load_cache

    split = load_cache(str(whole / "feature_cache.npz"))["split"]
    chunks = sum(-(-len(s) // TRAIN_BATCH) for s in split[1:])
    depth = TOWER["depth"]
    # the resumed run takes the steps after the cursor only (a fresh start
    # would take all of them); K1 also runs the GCN warm start's 2 updates
    expect = {"fwd": depth * (left + chunks), "fwd_bf16": 0, "bwd": depth * left,
              "bwd_bf16": 0, "adamw": left + 2}
    if bad or launches != expect or int(a["opt_state"]["count"]) != int(b["opt_state"]["count"]):
        raise RuntimeError(f"moe_resume: {len(bad)} leaves differ from the uninterrupted run "
                           f"({bad[:5]}); launches {launches}, expected {expect}")
    log("moe_resume", killed_at_step=MOE_SAVE_EVERY, steps=steps, resumed_steps=left,
        launches=json.dumps(launches, separators=(",", ":")),
        expected=json.dumps(expect, separators=(",", ":")), bit_identical=True,
        tensors_compared=2 + sum(len(sd) for sd in a["params"].values())
        + sum(len(sd) for key in ("mu", "nu") for sd in a["opt_state"][key].values()),
        killed_run_s=kill_s, resumed_run_s=resume_s, whole_run_s=whole_s,
        state_mb=(whole / "latest" / "state.pt").stat().st_size / 1e6)
    shutil.rmtree(whole, ignore_errors=True)
    shutil.rmtree(cut, ignore_errors=True)
    return launches


def phase_moe_serve(model_dir, requests):
    """The MoE export served on the card at 8, 64 and 300 records in f32,
    bf16 and int8 (each request REPEATS times after a warm-up), and
    explain(grad) of 8 records. The CPU reference scores each request as
    the card does, one chunk of all its rows (`predict_featurized`): the
    capacity depends on the tokens of the call, so the CPU Predictor's
    batch_size chunks would route (and drop) otherwise. f32: every token
    routed alike and rows within 1e-4; bf16 within 2e-2 of its own CPU run;
    int8 within 1e-4 of its own CPU run."""
    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
    from ultrafnd_git_tpu_torch.serving import FORENSIC_KEYS, Predictor

    def one_chunk(pred, recs):
        return pred.predict_featurized(pred.featurize(recs), len(recs))

    depth = TOWER["depth"]
    total = {"fwd": 0, "fwd_bf16": 0}
    lat_by = {}
    for levers in ({}, {"bf16": True}, {"quantize": True}):
        name = "+".join(levers) or "f32"
        gpu = Predictor(model_dir, device="cuda", **levers)
        cpu = Predictor(model_dir, device="cpu", **levers)
        try:
            if gpu.text_tower.moe_experts != MOE_EXPERTS:
                raise RuntimeError("the export does not serve a MoE tower")
            gpu.warmup(max(REQUEST_SIZES))
            _reset_counts()  # this path's run only
            rows, lat = _timed_requests(gpu, requests)
            grad = gpu.explain(requests[0], method="grad", top_k=512) if not levers else None
            launches = {"fwd": fa.launches, "fwd_bf16": fa.bf16_launches}
            g_routes, g_hooks = _moe_routes(gpu.text_tower)
            c_routes, c_hooks = _moe_routes(cpu.text_tower)
            try:
                last = [one_chunk(gpu, recs) for recs in requests]
                cpu_rows = [one_chunk(cpu, recs) for recs in requests]
            finally:
                for h in g_hooks + c_hooks:
                    h.remove()
            experts, slots = _routes_differing(g_routes, c_routes)
            ref = cpu.explain(requests[0], method="grad", top_k=512) if not levers else None
            if not levers:
                profile_request(gpu, requests[-1], "moe_serve", "f32")
        finally:
            gpu.close()
            cpu.close()
        bf16 = bool(levers.get("bf16"))
        n_fwd = depth * (len(REQUEST_SIZES) * REPEATS + (0 if levers else 1))
        want = {"fwd": 0 if bf16 else n_fwd, "fwd_bf16": n_fwd if bf16 else 0}
        if launches != want:
            raise RuntimeError(f"moe_serve {name}: launches {launches}, expected {want}")
        for k in total:
            total[k] += launches[k]
        if _values(rows).tolist() != _values(last).tolist():
            raise RuntimeError(f"moe_serve {name}: predict() and one chunk differ on the card")
        diffs = {k: float(np.max(np.abs(_values(rows, k) - _values(cpu_rows, k))))
                 for k in ("prob_fake", *FORENSIC_KEYS)}
        tol = LEVER_VS_CPU if bf16 else PROB_ATOL
        p = _values(rows)
        # f32: every token routed alike; bf16 and int8 change the router's
        # inputs or weights, so a near tie may go either way there
        if not (np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all()
                and max(diffs.values()) <= tol and (levers or slots == 0)):
            raise RuntimeError(f"moe_serve {name}: GPU vs CPU {diffs} (bound {tol}), "
                               f"{experts} tokens to another expert, {slots} in another slot")
        extra = {}
        if grad is not None:
            g = np.stack([[d[1] for d in sorted(r["explain"]["top_fused_dims"])] for r in grad])
            r = np.stack([[d[1] for d in sorted(x["explain"]["top_fused_dims"])] for x in ref])
            extra["explain_grad_vs_cpu_rel"] = float(np.abs(g - r).max()
                                                     / max(np.abs(r).max(), 1e-30))
            if not extra["explain_grad_vs_cpu_rel"] <= PROB_ATOL:
                raise RuntimeError(f"moe_serve explain(grad): GPU vs CPU {extra}")
        lat_by[name] = lat
        log("moe_serve", levers=name, launches=json.dumps(launches, separators=(",", ":")),
            expected=json.dumps(want, separators=(",", ":")),
            gpu_vs_cpu_max_abs=json.dumps(diffs, separators=(",", ":")), bound=tol,
            tokens_to_another_expert=experts, tokens_in_another_slot=slots,
            tokens_compared=sum(int(e.numel()) for e, _ in c_routes),
            median_latency_ms=json.dumps({n: round(1e3 * t, 3) for n, t in
                                          zip(REQUEST_SIZES, lat)}),
            prob_min=float(p.min()), prob_max=float(p.max()), **extra)
    return {"launches": total, "latency_s": lat_by}


def phase_auto_salt(data_root, root):
    """The CLI's --auto_salt a on the raw data root (--use_evidence
    --train_text_tower, full width, one epoch): two candidate runs (the
    unsalted one and "a"), each building its cache from the root, the
    winner adopted and its best slot tested; salt_search.json names the
    winner and the adopted out_dir exports (its align.pt came along) and
    serves on the card."""
    from ultrafnd_git_tpu_torch.data.cache import load_cache
    from ultrafnd_git_tpu_torch.serving import Predictor

    out, exported = Path(root) / "salt_run", Path(root) / "salt_model"
    argv = ["--data_root", str(data_root), "--out_dir", str(out), "--use_evidence",
            "--train_text_tower", "--text_tower_depth", str(TOWER["depth"]),
            "--text_tower_heads", str(TOWER["heads"]), "--batch_size", str(TRAIN_BATCH),
            "--epochs", "1", "--seed", "0", "--auto_salt", "a",
            "--export_model_dir", str(exported)]
    _reset_counts()  # this path's run only
    t0 = time.perf_counter()
    results, said = _train_cli(argv)
    wall_s = time.perf_counter() - t0
    launches = _launch_counts()
    record = json.loads((out / "salt_search.json").read_text())
    winner = record["winner"]
    if record["candidates"] != ["", "a"] or f"Selected hash_salt: {winner!r}" not in said \
            or record["val_scores"][winner] != max(record["val_scores"].values()):
        raise RuntimeError(f"auto_salt: bad search record {record}")
    missing = [f for f in ("best/meta.json", "latest/meta.json", "feature_cache.npz",
                           "metrics.jsonl", "align.pt") if not (out / f).exists()]
    split = load_cache(str(out / "feature_cache.npz"))["split"]
    steps = -(-len(split[0]) // TRAIN_BATCH)
    va, te = (-(-len(s) // TRAIN_BATCH) for s in split[1:])
    depth = TOWER["depth"]
    # two candidate runs (K1: steps + the GCN warm start's 2 each), then
    # the winner's test under --eval_only (no warm start, no backward)
    expect = {"fwd": depth * (2 * (steps + va) + te), "fwd_bf16": 0, "bwd": depth * 2 * steps,
              "bwd_bf16": 0, "adamw": 2 * (steps + 2)}
    if missing or launches != expect or not all(np.isfinite(v) for v in results.values()):
        raise RuntimeError(f"auto_salt: missing {missing}; launches {launches}, expected "
                           f"{expect}; results {results}")
    pred = Predictor(str(exported), device="cuda")
    try:
        recs = raw_records(8, np.random.default_rng(4), "salt")
        p = np.array([r["prob_fake"] for r in pred.predict(recs)])
    finally:
        pred.close()
    if json.loads((exported / "meta.json").read_text())["cfg"]["hash_salt"] != winner \
            or not (np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all()):
        raise RuntimeError(f"auto_salt: the adopted out_dir does not serve: {p}")
    log("auto_salt", winner=repr(winner), val_scores=json.dumps(record["val_scores"]),
        launches=json.dumps(launches, separators=(",", ":")),
        expected=json.dumps(expect, separators=(",", ":")), cli_wall_s=wall_s,
        test=json.dumps({k: round(v, 6) for k, v in results.items()}),
        served_prob=json.dumps([round(float(x), 6) for x in p]))
    shutil.rmtree(out, ignore_errors=True)
    return launches

ARTIFACT_LEVERS = (("f32", {}), ("bf16", {"bf16": True}), ("int8", {"quantize": True}))
ARTIFACT_BATCH = 64  # the artifact's chunk rows (the Predictor's default batch_size)
ARTIFACT_VS_LIVE = 1e-6  # artifact rows vs the live Predictor on the same chunks
LEGACY_VS_FUSED = 1e-5  # legacy GPU rows vs fused GPU rows


def _max_gap(rows, ref, keys=("prob_fake", "semantic_conflict", "temporal_delay",
                              "emotion_intensity")):
    return max(float(np.max(np.abs(_values(rows, k) - _values(ref, k)))) for k in keys)


def phase_artifact_serve(model_dir, requests, serve, root):
    """The served model frozen into an artifact on the card in f32, bf16 and
    int8 (export_serving.export_artifact: torch.export of the scoring
    program), each served by ExportedPredictor on the card: the requests
    five times after a warm-up, K2 launches = depth x chunks of 64 rows
    (the artifact caps chunks at batch_size), rows against the live
    Predictor run on the same chunks (the same program: within 1e-6) and
    on its own chunks; latencies beside the live Predictor's; the export's
    seconds and file sizes. Then the model frozen on the CPU and served on
    the card, against the CPU Predictor."""
    from ultrafnd_git_tpu_torch.export_serving import FILES, ExportedPredictor, export_artifact
    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
    from ultrafnd_git_tpu_torch.serving import Predictor

    depth = TOWER["depth"]
    chunks = [-(-n // ARTIFACT_BATCH) for n in REQUEST_SIZES]
    expect = depth * REPEATS * sum(chunks)
    total = {"fwd": 0, "fwd_bf16": 0}
    for name, levers in ARTIFACT_LEVERS:
        art_dir = root / f"artifact_{name}"
        live = Predictor(model_dir, device="cuda", batch_size=ARTIFACT_BATCH, **levers)
        try:
            live.warmup(max(REQUEST_SIZES))
            live_rows, live_lat = _timed_requests(live, requests)
            t0 = time.perf_counter()
            export_artifact(live, str(art_dir), platforms=("cuda", "cpu"))
            export_s = time.perf_counter() - t0
            live._fixed_shape_dispatch = True  # the artifact's chunks, the live program
            same_chunks = [live.predict(recs) for recs in requests]
        finally:
            live.close()
        sizes = {f: (art_dir / f).stat().st_size for f in FILES}
        t1 = time.perf_counter()
        art = ExportedPredictor(str(art_dir), device="cuda")
        load_s = time.perf_counter() - t1
        try:
            art.warmup(max(REQUEST_SIZES))
            _reset_counts()  # this path's run only
            rows, lat = _timed_requests(art, requests)
            launches = {"fwd": fa.launches, "fwd_bf16": fa.bf16_launches}
            if fa.bwd_launches or fa.bwd_bf16_launches:
                raise RuntimeError("an artifact launched a backward kernel")
            profile_request(art, requests[-1], "artifact_serve", name)
        finally:
            art.close()
        bf16 = bool(levers.get("bf16"))
        want = {"fwd": 0 if bf16 else expect, "fwd_bf16": expect if bf16 else 0}
        if launches != want:
            raise RuntimeError(f"artifact {name}: K2 launches {launches}, expected {want}: "
                               "the kernel did not run inside scorer.pt2")
        for k in total:
            total[k] += launches[k]
        gap = _max_gap(rows, same_chunks)
        identical = all(a == b for x, y in zip(rows, same_chunks) for a, b in zip(x, y))
        own = float(np.abs(_values(rows) - _values(live_rows)).max())
        own_tol = LEVER_VS_CPU if bf16 else PROB_ATOL
        p = _values(rows)
        if not (np.isfinite(p).all() and gap <= ARTIFACT_VS_LIVE and own <= own_tol):
            raise RuntimeError(f"artifact {name}: {gap} from the live program on its chunks "
                               f"(limit {ARTIFACT_VS_LIVE}), {own} from the live Predictor's "
                               f"own chunks (limit {own_tol})")
        log("artifact_serve", lever=name, export_s=export_s, load_s=load_s,
            file_bytes=json.dumps(sizes, separators=(",", ":")),
            launches=json.dumps(launches, separators=(",", ":")), expected_launches=expect,
            max_abs_vs_live_same_chunks=gap, bit_identical=identical,
            max_abs_vs_live_own_chunks=own,
            median_latency_ms=json.dumps({n: round(1e3 * t, 3) for n, t in
                                          zip(REQUEST_SIZES, lat)}),
            live_median_latency_ms=json.dumps({n: round(1e3 * t, 3) for n, t in
                                               zip(REQUEST_SIZES, live_lat)}))

    # frozen on the CPU, served on the card
    cpu_dir = root / "artifact_cpu"
    cpu = Predictor(model_dir, device="cpu", batch_size=ARTIFACT_BATCH)
    try:
        t0 = time.perf_counter()
        export_artifact(cpu, str(cpu_dir), platforms=("cpu", "cuda"))
        export_s = time.perf_counter() - t0
    finally:
        cpu.close()
    art = ExportedPredictor(str(cpu_dir), device="cuda")
    try:
        _reset_counts()
        rows = [art.predict(recs) for recs in requests]
        launches = fa.launches
    finally:
        art.close()
    gap = _max_gap(rows, serve["cpu_rows"])
    if launches != depth * sum(chunks) or not gap <= PROB_ATOL:
        raise RuntimeError(f"the CPU-exported artifact on the card: K2 launches {launches} "
                           f"(expected {depth * sum(chunks)}), {gap} from the CPU Predictor")
    total["fwd"] += launches
    log("artifact_serve", lever="f32 exported on the cpu", export_s=export_s,
        launches=launches, max_abs_vs_cpu_predictor=gap)
    return total


def phase_legacy_serve(model_dir, requests):
    """Predictor(fused_align=False) on the card: featurize builds the full
    cache (its align pass on the card), the legacy program scores it. The
    three requests in turns with the fused Predictor (REPEATS times each,
    the order alternating), then each against the CPU legacy Predictor
    (1e-4) and the fused GPU rows (1e-5); featurize medians of both."""
    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
    from ultrafnd_git_tpu_torch.serving import Predictor

    fused = Predictor(model_dir, device="cuda")
    legacy = Predictor(model_dir, device="cuda", fused_align=False)
    preds = {"fused": fused, "legacy": legacy}
    try:
        for pred in preds.values():
            pred.warmup(max(REQUEST_SIZES))
        lat = {k: [] for k in preds}
        feat = {k: [] for k in preds}
        rows = {k: [] for k in preds}
        launched = {"fused": 0, "legacy": 0}
        for recs in requests:
            times, last = {k: [] for k in preds}, {}
            for rep in range(REPEATS):
                for k in (("fused", "legacy") if rep % 2 == 0 else ("legacy", "fused")):
                    before = fa.launches
                    s = time.perf_counter()
                    last[k] = preds[k].predict(recs)
                    times[k].append(time.perf_counter() - s)
                    launched[k] += fa.launches - before
            for k, pred in preds.items():
                rows[k].append(last[k])
                lat[k].append(statistics.median(times[k]))
                ft = []
                for _ in range(REPEATS):
                    s = time.perf_counter()
                    pred.featurize(recs)
                    ft.append(time.perf_counter() - s)
                feat[k].append(statistics.median(ft))
    finally:
        fused.close()
        legacy.close()
    cpu = Predictor(model_dir, device="cpu", fused_align=False)
    try:
        cpu_rows = [cpu.predict(recs) for recs in requests]
    finally:
        cpu.close()
    expect = TOWER["depth"] * REPEATS * len(REQUEST_SIZES)  # one GPU chunk a request
    vs_cpu, vs_fused = _max_gap(rows["legacy"], cpu_rows), _max_gap(rows["legacy"], rows["fused"])
    if launched["legacy"] != expect or not (vs_cpu <= PROB_ATOL and vs_fused <= LEGACY_VS_FUSED):
        raise RuntimeError(f"legacy serving: K2 launches {launched}, expected {expect} each; "
                           f"{vs_cpu} from the CPU legacy run, {vs_fused} from the fused rows")
    log("legacy_serve", launches=json.dumps(launched, separators=(",", ":")), expected=expect,
        max_abs_vs_cpu_legacy=vs_cpu, max_abs_vs_fused_gpu=vs_fused,
        **{f"{k}_median_latency_ms": json.dumps({n: round(1e3 * t, 3) for n, t in
                                                 zip(REQUEST_SIZES, lat[k])}) for k in preds},
        **{f"{k}_featurize_median_ms": json.dumps({n: round(1e3 * t, 3) for n, t in
                                                   zip(REQUEST_SIZES, feat[k])}) for k in preds})
    return launched["legacy"]


def phase_integrated_train(data_root, root):
    """The training CLI with --trainer integrated on raw_train's data root
    (N = 5376), batch 512, one epoch, then --eval_only, in f32 and under
    --bf16: losses finite, K1 launches = steps and no flash kernel; the
    median step and the idle share of a profiled step; the dropout-off
    gradient of one batch (512 rows) on the card against the CPU, from the
    same initial parameters."""
    import torch

    from ultrafnd_git_tpu_torch.data.cache import load_cache
    from ultrafnd_git_tpu_torch.training.trainer_integrated import (
        IntegratedForensicTrainer,
        IntegratedTrainConfig,
    )

    total = {"fwd": 0, "fwd_bf16": 0, "bwd": 0, "bwd_bf16": 0, "adamw": 0}
    for bf16 in (False, True):
        phase = "integrated_train" + ("_bf16" if bf16 else "")
        out = root / f"{phase}_run"
        argv = ["--trainer", "integrated", "--data_root", str(data_root), "--out_dir", str(out),
                "--batch_size", str(TRAIN_BATCH), "--epochs", "1", "--seed", "0"]
        argv += ["--bf16"] if bf16 else []
        step_ms = []
        train_step = IntegratedForensicTrainer.train_step

        def timed_step(self, idx, mask, thr, _inner=train_step):
            torch.cuda.synchronize()
            s = time.perf_counter()
            result = _inner(self, idx, mask, thr)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - s))
            return result

        IntegratedForensicTrainer.train_step = timed_step
        _reset_counts()  # this path's run only
        t0 = time.perf_counter()
        try:
            results, said = _train_cli(argv)
        finally:
            IntegratedForensicTrainer.train_step = train_step
        launches = _launch_counts()
        wall_s = time.perf_counter() - t0
        cache = load_cache(str(out / "feature_cache.npz"))
        tr = len(cache["split"][0])
        steps = len(step_ms)
        expect = {"fwd": 0, "fwd_bf16": 0, "bwd": 0, "bwd_bf16": 0, "adamw": steps}
        if steps != -(-tr // TRAIN_BATCH) or launches != expect:
            raise RuntimeError(f"{phase}: launches {launches} over {steps} steps, "
                               f"expected {expect}")
        rows = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
        losses = [r[k] for r in rows for k in ("train_loss", "val_loss")] + [results["test_loss"]]
        kinds = {json.loads((out / s / "meta.json").read_text())["trainer"]
                 for s in ("best", "latest")}
        if not np.isfinite(losses).all() or not all(np.isfinite(v) for v in results.values()) \
                or "==== Final Results ====" not in said or kinds != {"integrated"}:
            raise RuntimeError(f"{phase}: losses {losses}, results {results}, slots {kinds}")
        for k in total:
            total[k] += launches[k]
        _reset_counts()
        _, said = _train_cli(argv + ["--eval_only"])
        eval_launches = _launch_counts()
        if "feature cache: reusing" not in said or any(eval_launches.values()):
            raise RuntimeError(f"{phase} --eval_only: launches {eval_launches}, or the cache "
                               "was not reused")

        # the dropout-off gradient of one batch, card against CPU, from the
        # same initial parameters (one seeded draw on the CPU for both)
        t1 = time.perf_counter()
        grads, trainers = {}, {}
        for dev in ("cuda", "cpu"):
            cfg = IntegratedTrainConfig(out_dir=str(root / f"{phase}_grad_{dev}"),
                                        batch_size=TRAIN_BATCH, epochs=1, seed=0,
                                        bf16_compute=bf16, cache_to_disk=False)
            t = trainers[dev] = IntegratedForensicTrainer(cfg, cache=dict(cache), device=dev)
            idx = torch.from_numpy(np.asarray(t.train_idx[:TRAIN_BATCH], np.int64)).to(t.device)
            mask = torch.ones(TRAIN_BATCH, device=t.device)
            grads[dev] = t.grads_of(idx, mask, t.annealed_thresh(0))[1]
        (rel, leaf), (l2, l2_leaf) = _leaf_gaps(grads["cuda"], grads["cpu"])
        bounds = (BF16_GRAD_MAX, BF16_GRAD_L2) if bf16 else (GRAD_RTOL, float("inf"))
        if not (rel <= bounds[0] and l2 <= bounds[1]):
            raise RuntimeError(f"{phase}: GPU vs CPU gradient {leaf} differs by {rel} of its "
                               f"max, {l2_leaf} by {l2} in L2 (bounds {bounds})")
        gpu = trainers["cuda"]
        chunk = np.asarray(gpu.train_idx[:TRAIN_BATCH], np.int32)
        ones = np.ones(TRAIN_BATCH, np.float32)
        median_step = statistics.median(step_ms[1:])
        device_ms = profile_step(gpu, median_step, phase=phase,
                                 step=lambda: gpu.train_step(chunk, ones, gpu.annealed_thresh(0)))
        log(phase, records=N_CORPUS, train_rows=tr, steps=steps,
            launches=json.dumps(launches, separators=(",", ":")),
            eval_only_launches=json.dumps(eval_launches, separators=(",", ":")),
            first_step_ms=step_ms[0], median_step_ms=median_step,
            samples_per_s=TRAIN_BATCH * 1e3 / median_step, step_device_ms=device_ms,
            cli_wall_s=wall_s, losses=json.dumps([round(x, 6) for x in losses]),
            test=json.dumps({k: round(v, 6) for k, v in results.items()}),
            gpu_vs_cpu_grad_max_rel=rel, worst_leaf=leaf, gpu_vs_cpu_grad_l2_rel=l2,
            worst_l2_leaf=l2_leaf, bounds=json.dumps(bounds), check_s=time.perf_counter() - t1)
    return total


def v1_clips(rng, n=V1_BATCH, frames=V1_FRAMES):
    """(n, frames, 256, 256, 3) uint8 clips of 8-px colour blocks (bench.py's
    structured frames), whose content moves V1_SHIFT = (dy, dx) px a frame:
    frame t is the 256 x 256 window of a 384 x 384 base at (-dy t, 64 - dx t)."""
    dy, dx = V1_SHIFT
    base = np.kron(rng.integers(0, 256, (n, 48, 48, 3), dtype=np.uint8),
                   np.ones((1, 8, 8, 1), np.uint8))
    return np.stack([base[:, -dy * t : -dy * t + 256, 64 - dx * t : 320 - dx * t]
                     for t in range(frames)], axis=1)


def v1_batch(rng, i):
    """A collated raw-media batch of V1_BATCH records: text fields, 5 s
    waveforms (a tone in noise), moving clips and alternating labels."""
    recs = raw_records(V1_BATCH, rng, f"v1_{i}")
    t = np.arange(80000, dtype=np.float32) / 16000.0
    tones = rng.uniform(100.0, 3000.0, (V1_BATCH, 1)).astype(np.float32)
    audio = (0.3 * np.sin(2 * np.pi * tones * t) + 0.05 * rng.standard_normal(
        (V1_BATCH, 80000))).astype(np.float32)
    return {"text_data": [{k: r[k] for k in ("title", "ocr", "comments")} for r in recs],
            "audio_waveform": audio, "video_frames": v1_clips(rng),
            "label": np.arange(V1_BATCH, dtype=np.int64) % 2, "video_id": [r["video_id"] for r in recs]}


def _profiled(fn, phase=None, rows=5):
    """(result, kernel launches, device ms of the kernels, HtoD copy ms,
    wall ms) of one call of `fn` under torch.profiler; with `phase`, its
    `rows` longest kernels are logged."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - s)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if e.key.startswith("Memcpy") or e.key.startswith("Memset")]
    kernels = [e for e in events if e not in copies]
    if phase is not None:
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:rows]
        log(phase, top_kernels=json.dumps([[e.key[:60], e.count, e.self_device_time_total / 1e3]
                                           for e in top]))
    return (out, sum(e.count for e in kernels),
            sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.self_device_time_total for e in copies if "HtoD" in e.key) / 1e3, wall_ms)


def phase_v1_train(dev, root):
    """The v1 raw-media ensemble pipeline on the card: the device CV stage at
    the path's size against its CPU run, the feature stage in turns with the
    host cv2 ladder, the ensemble's steps through K1, and the CLI on a copy
    of the fixture's records with video."""
    import torch

    from ultrafnd_git_tpu_torch.kernels import adamw as aw, preprocess as pre
    from ultrafnd_git_tpu_torch.training import pipeline_v1 as v1

    t_phase = time.perf_counter()
    rng = np.random.default_rng(12)
    dy, dx = V1_SHIFT
    launches = {"fwd": 0, "fwd_bf16": 0, "bwd": 0, "bwd_bf16": 0, "adamw": 0}

    # 1. the device CV stage at (8, 30, 256, 256), on the host gray the path uploads
    clips = v1_clips(rng)
    gray = v1.BatchFeatureExtractor._gray_host(clips)
    gpu, cpu = pre.DeviceCVStage(device=str(dev)), pre.DeviceCVStage(device="cpu")
    first, second, ref, ref2 = gpu(gray), gpu(gray), cpu(gray), cpu(gray)
    if any(not np.array_equal(first[k], second[k]) for k in first):
        raise RuntimeError("v1_train: the CV stage differs between two calls on the card")
    if any(not np.array_equal(ref[k], ref2[k]) for k in ref):  # the reference must hold still
        raise RuntimeError("v1_train: the CV stage differs between two calls on the CPU")

    def block_flow(dev):
        half = pre._pyr_down(pre.gray_resize(torch.from_numpy(gray).to(dev)))
        with torch.inference_mode():
            u, v = pre.block_match_flow(half[:, :-1].reshape(-1, 128, 128),
                                        half[:, 1:].reshape(-1, 128, 128))
        return 2 * u.cpu().numpy(), 2 * v.cpu().numpy()  # full-raster px

    (gu, gv), (cu, cv) = block_flow(dev), block_flow("cpu")
    flips = int((np.abs(gu - cu) > 0.25).sum() + (np.abs(gv - cv) > 0.25).sum())
    inner = (slice(None), slice(2, -2), slice(2, -2))
    med = (float(np.median(gv[inner])), float(np.median(gu[inner])))
    gaps = {"flow_feat": float(np.abs(first["flow_feat"] - ref["flow_feat"]).max()),
            "cuts": float(np.abs(first["cuts"] - ref["cuts"]).max()),
            "flow_mags_rel": float(np.abs(first["flow_mags"] - ref["flow_mags"]).max()
                                   / np.abs(ref["flow_mags"]).max())}
    if (flips or gaps["flow_feat"] > CV_FEAT_ATOL or gaps["cuts"] > CV_CUTS_ATOL
            or gaps["flow_mags_rel"] > CV_MAGS_REL or abs(med[0] - dy) > 0.3
            or abs(med[1] - dx) > 0.3 or not np.isfinite(first["flow_feat"]).all()):
        raise RuntimeError(f"v1_train: CV stage on the card vs the CPU: {flips} flips, gaps "
                           f"{gaps}, median block flow {med} for {V1_SHIFT}")
    gpu.dispatch(gray)  # warm
    # dispatch enqueues upload and stage without waiting for the device: no
    # operation in it may synchronise (torch's sync debug mode names any)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            gpu.dispatch(gray)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:120] for w in caught if "synchroniz" in str(w.message)]
    if syncs:
        raise RuntimeError(f"v1_train: the CV stage's dispatch synchronised: {syncs}")
    _, stage_launches, stage_device_ms, upload_ms, stage_wall_ms = _profiled(
        lambda: gpu.dispatch(gray), phase="v1_train")
    stage_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        s = time.perf_counter()
        gpu.finalize(gpu.dispatch(gray))
        stage_ms.append(1e3 * (time.perf_counter() - s))
    s = time.perf_counter()
    cpu(gray)
    cpu_stage_ms = 1e3 * (time.perf_counter() - s)
    log("v1_train", part="cv_stage", clips=list(clips.shape), upload=list(gray.shape),
        upload_bytes=gray.nbytes, upload_ms=upload_ms, stage_device_ms=stage_device_ms,
        stage_launches=stage_launches, profiled_wall_ms=stage_wall_ms,
        stage_median_ms=statistics.median(stage_ms), stage_cpu_ms=cpu_stage_ms, flips=flips,
        median_flow_dy_dx=json.dumps(med), shift=json.dumps(V1_SHIFT), dispatch_syncs=0, **gaps,
        bounds=json.dumps([CV_FEAT_ATOL, CV_CUTS_ATOL, CV_MAGS_REL]), bit_identical=True)

    # 2. the feature stage over V1_STREAM_BATCHES batches, in turns with the host ladder
    batches = [v1_batch(rng, i) for i in range(V1_STREAM_BATCHES)]
    ext = v1.BatchFeatureExtractor(seed=0, device=str(dev))
    ext_host = v1.BatchFeatureExtractor(seed=0, device=str(dev), use_device_cv=False)
    if ext._device_cv is None or ext_host._device_cv is not None:
        raise RuntimeError("v1_train: the extractor on the card did not take the CV stage")

    def stream(e):
        s = time.perf_counter()
        feats = [f for f, _, _ in e.stream((b, i) for i, b in enumerate(batches))]
        return feats, 1e3 * (time.perf_counter() - s) / (V1_BATCH * len(batches))

    ext(batches[0])  # warm both rungs (pool threads, first launches)
    ext_host(batches[0])
    per_sample = {"stage": [], "host_ladder": []}
    feats = {}
    for name in ("stage", "host_ladder", "host_ladder", "stage"):
        feats[name], ms = stream(ext if name == "stage" else ext_host)
        per_sample[name].append(ms)
    for k in ("text", "audio"):
        if not all(np.array_equal(a[k], b[k]) for a, b in zip(feats["stage"],
                                                               feats["host_ladder"])):
            raise RuntimeError(f"v1_train: the two rungs' {k} columns differ")
    if not all(np.isfinite(f[k]).all() for f in feats["stage"] for k in f):
        raise RuntimeError("v1_train: a non-finite feature")
    _, batch_launches, batch_device_ms, _, batch_wall_ms = _profiled(lambda: ext(batches[1]))
    b0 = batches[0]
    records = [{"title": t["title"], "ocr": t["ocr"], "comments": t["comments"]}
               for t in b0["text_data"]]
    host_ms = {}
    for name, fn in (("ela", lambda: [ext.ela.ela_lbp(c) for c in b0["video_frames"]]),
                     ("spectral", lambda: ext.audio_enc.extract_waveform_batch(
                         b0["audio_waveform"])),
                     ("text", lambda: ext.text_enc.encode_fields_batch(records))):
        s = time.perf_counter()
        fn()
        host_ms[name] = 1e3 * (time.perf_counter() - s)
    os.environ["ULTRAFND_TEXT_DEVICE"] = "1"  # the text ladder's seeded tower rung
    try:
        ext_tower = v1.BatchFeatureExtractor(seed=0, device=str(dev))
    finally:
        del os.environ["ULTRAFND_TEXT_DEVICE"]
    _reset_counts()  # this batch only
    s = time.perf_counter()
    tower_feats = ext_tower(b0)
    torch.cuda.synchronize()
    tower_ms = 1e3 * (time.perf_counter() - s)
    tower_launches = _launch_counts()
    ext_tower.close()
    strings = sum(1 for r in records for t in [r["title"], r["ocr"], *r["comments"][:10]] if t)
    chunks = -(-strings // TEXT_CHUNK)
    if tower_launches != dict(dict.fromkeys(launches, 0), fwd=4 * chunks) or not np.isfinite(
            tower_feats["text"]).all():
        raise RuntimeError(f"v1_train: the tower rung launched {tower_launches} over "
                           f"{chunks} chunks")
    for k in launches:
        launches[k] += tower_launches[k]
    log("v1_train", part="features", batches=len(batches), batch=V1_BATCH,
        stage_ms_per_sample=json.dumps(per_sample["stage"]),
        host_ladder_ms_per_sample=json.dumps(per_sample["host_ladder"]),
        profiled_batch_wall_ms=batch_wall_ms, profiled_batch_device_ms=batch_device_ms,
        profiled_batch_launches=batch_launches,
        device_idle_share=max(0.0, 1.0 - batch_device_ms / batch_wall_ms),
        host_ms=json.dumps({k: round(v, 3) for k, v in host_ms.items()}),
        text_tower_batch_ms=tower_ms, text_tower_strings=strings,
        text_tower_k2=tower_launches["fwd"], text_tower_chunks=chunks)
    ext.close()
    ext_host.close()

    # 3. the ensemble (E = 2, the configured widths) on the stage's features
    labels = [b["label"] for b in batches]
    cfg = v1.V1Config(batch_size=V1_BATCH, ensemble_size=2, seed=0)
    trainer = v1.EnsembleTrainer(cfg, device=str(dev))
    lam, perm = v1.mixup_arrays(np.random.default_rng(0), V1_BATCH, cfg.mixup_alpha)
    g_grads = trainer.grads_of(feats["stage"][0], labels[0], lam, perm)[1]
    c_grads = v1.EnsembleTrainer(cfg, device="cpu").grads_of(feats["stage"][0], labels[0], lam,
                                                            perm)[1]
    worst = (0.0, "")
    for e, (gm, cm) in enumerate(zip(g_grads, c_grads)):
        for part in gm:
            for name, g in gm[part].items():
                r = cm[part][name].numpy()
                gap = float(np.abs(g.cpu().numpy() - r).max())
                rel = (gap - V1_GRAD_FLOOR) / max(float(np.abs(r).max()), 1e-30)
                if rel > worst[0]:
                    worst = (rel, f"member {e} {part}.{name}")
    if worst[0] > GRAD_RTOL:
        raise RuntimeError(f"v1_train: GPU vs CPU gradient {worst[1]} differs by {worst[0]} "
                           "of its largest")
    host_rng = np.random.default_rng(0)
    step_ms, losses = [], []
    _reset_counts()  # the ensemble's run only
    for _ in range(V1_EPOCHS):
        for f, y in zip(feats["stage"], labels):
            torch.cuda.synchronize()
            s = time.perf_counter()
            losses.append(trainer.train_batch(f, y, host_rng))
            step_ms.append(1e3 * (time.perf_counter() - s))
    ens_launches = _launch_counts()
    if ens_launches != dict(dict.fromkeys(launches, 0), adamw=trainer.step_count) \
            or not np.isfinite(losses).all():
        raise RuntimeError(f"v1_train: ensemble launches {ens_launches} over "
                           f"{trainer.step_count} steps, losses {losses}")
    for k in launches:
        launches[k] += ens_launches[k]
    _, step_launches, step_device_ms, _, step_wall_ms = _profiled(
        lambda: trainer.train_batch(feats["stage"][0], labels[0], host_rng), phase="v1_train")
    probs = trainer.predict_batch(feats["stage"][0])
    n_params = sum(p.numel() for m in trainer.params.values() for p in m.parameters())
    leaves = trainer.tx._leaves(trainer.params, trainer.opt_state, trainer._grad_bufs)
    scal = trainer.tx.scalars(trainer._grad_bufs, trainer.opt_state["count"])
    # K1 on this path's table and mode (210 leaves of two members, no clip of
    # its own, the members' pre-scaled grads) bit for bit against the plain
    # update, each on its own copy of the trained state
    fused_copy = [tuple(t.clone() for t in leaf) for leaf in leaves]
    plain_copy = [tuple(t.clone() for t in leaf) for leaf in leaves]
    k1_scalar_leaves = _unaligned_leaves(fused_copy)
    aw.fused_adamw_(fused_copy, scal)
    for leaf in plain_copy:
        aw.adamw_reference_(*leaf, scal)
    torch.cuda.synchronize()
    k1_err = 0.0
    for i, (a, b) in enumerate(zip(fused_copy, plain_copy)):
        for t, (x, y) in enumerate(zip(a[:3], b[:3])):  # p, m, v
            if not torch.equal(x, y):
                raise RuntimeError(f"v1_train: K1 differs from the plain update at leaf {i} "
                                   f"({'pmv'[t]})")
            k1_err = max(k1_err, _max_err(x, y))
    del fused_copy, plain_copy
    k1_ms = _median_ms(lambda: aw.fused_adamw_(leaves, scal), runs=20, calls=5)
    k1_plain_ms = _median_ms(lambda: [aw.adamw_reference_(*leaf, scal) for leaf in leaves],
                             runs=10, calls=2, lead=False)
    # the yardstick on this table: torch's fused AdamW, no clip (as K1 here)
    library, restore = _library_adamw(leaves, trainer.tx, None, dev)
    k1_library_ms = _median_ms(library, runs=20, calls=5, before_block=restore)
    del library, restore
    log("v1_train", part="ensemble", members=2, batch=V1_BATCH, params=n_params,
        leaves=len(leaves), steps=trainer.step_count, launches=json.dumps(ens_launches),
        median_step_ms=statistics.median(step_ms[1:]), first_step_ms=step_ms[0],
        profiled_step_launches=step_launches, profiled_step_device_ms=step_device_ms,
        profiled_step_wall_ms=step_wall_ms,
        step_idle_share=max(0.0, 1.0 - step_device_ms / statistics.median(step_ms[1:])),
        losses=json.dumps([round(x, 6) for x in losses[:: V1_STREAM_BATCHES]]),
        gpu_vs_cpu_grad_max_rel=worst[0], worst_leaf=worst[1], grad_floor=V1_GRAD_FLOOR,
        probs_finite=bool(np.isfinite(probs).all()), k1_vs_plain_max_abs_err=k1_err,
        k1_bit_identical=True, k1_scalar_leaves=k1_scalar_leaves, k1_ms=k1_ms,
        k1_plain_ms=k1_plain_ms, k1_library_ms=k1_library_ms,
        k1_library="torch._fused_adamw_ over the same 210 leaves, no grad_scale",
        **_bound(4 * 7 * n_params, ADAMW_FLOP * n_params, F32_FLOPS))

    # 4. the CLI on the fixture's records with video, then --debug
    v1_root = root / "v1_root"
    (v1_root / "video_comment").mkdir(parents=True)
    have = {p.stem for p in (FIXTURE / "videos").glob("*.avi")}
    lines = [ln for ln in (FIXTURE / "data_complete.json").read_text(encoding="utf-8")
             .splitlines() if json.loads(ln)["video_id"] in have][:8]
    (v1_root / "data_complete.json").write_text("\n".join(lines), encoding="utf-8")
    shutil.copytree(FIXTURE / "videos", v1_root / "videos")
    for f in (FIXTURE / "video_comment").glob("*.json"):
        shutil.copy(f, v1_root / "video_comment" / f.name)
    stage_devices = []
    dispatch = pre.DeviceCVStage.dispatch

    def recording(self, frames):
        out = dispatch(self, frames)
        stage_devices.append(sorted({t.device.type for t in out.values()}))
        return out

    pre.DeviceCVStage.dispatch = recording
    cli = {}
    try:
        for name, argv in (("data_dir", ["--data_dir", str(v1_root), "--epochs", "2"]),
                           ("debug", ["--debug", "--epochs", "2"])):
            stage_devices.clear()
            tee = _Tee(sys.stdout)
            _reset_counts()  # this run only
            s = time.perf_counter()
            with contextlib.redirect_stdout(tee):
                res = v1.main(argv + ["--batch_size", "4", "--eval_every", "1",
                                      "--device", dev.type])
            wall_s = time.perf_counter() - s
            run = _launch_counts()
            said = "".join(tee.text)
            m = re.search(r"decode_failures: (\d+)", said)
            ok = (np.isfinite(res["loss"]) and res["steps"] > 0
                  and run == dict(dict.fromkeys(launches, 0), adamw=res["steps"]))
            if name == "data_dir":
                ok = ok and m is not None and bool(stage_devices) and all(
                    d == [dev.type] for d in stage_devices)
            if not ok:
                raise RuntimeError(f"v1_train CLI {name}: results {res}, launches {run}, "
                                   f"stage dispatches on {stage_devices}")
            for k in launches:
                launches[k] += run[k]
            cli[name] = {"results": res, "wall_s": wall_s, "stage_dispatches": len(stage_devices),
                         "decode_failures": int(m.group(1)) if m else None}
    finally:
        pre.DeviceCVStage.dispatch = dispatch
    log("v1_train", part="cli", runs=json.dumps(cli, default=float), launches=json.dumps(launches),
        phase_wall_s=time.perf_counter() - t_phase, script_wall_s=time.perf_counter() - T0)
    return launches


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _plain_gloo_reference(cfg, out_dir):
    """The plain trainer's first MESH_GLOO_STEPS steps of `cfg` on the card,
    the reference of mesh_train (b): their losses, the clip norm of every
    AdamW update (the GCN warm start's first), and the parameters and
    AdamW moments after them (on the CPU)."""
    import torch

    from ultrafnd_git_tpu_torch.kernels.adamw import AdamW
    from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer, TrainConfig

    norms, scalars = [], AdamW.scalars

    def recorded(self, grads, count):
        row = scalars(self, grads, count)
        norms.append(float(row[0]))
        return row

    AdamW.scalars = recorded
    try:
        t = ForensicTrainer(TrainConfig(**cfg, out_dir=str(out_dir)), device="cuda")
        losses = [float(t.train_step(c, m)[0])
                  for c, m, _ in t.epoch_batches(t.tr_idx, True)[:MESH_GLOO_STEPS]]
    finally:
        AdamW.scalars = scalars
    full = t.state.state_dict()
    cpu = lambda tree: {part: {k: v.cpu() for k, v in sd.items()}  # noqa: E731
                        for part, sd in tree.items()}
    ref = {"losses": losses, "norms": norms, "params": cpu(full["params"]),
           "mu": cpu(full["opt_state"]["mu"]), "nu": cpu(full["opt_state"]["nu"])}
    del t, full
    torch.cuda.empty_cache()
    return ref


def _profile_mesh_step(step, median_ms, label):
    """(device ms, NCCL kernels' ms, their count, idle share) of one
    profiled step; its six longest kernels are printed under `label`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log("mesh_train", step=label, kernel=json.dumps(e.key[:90]), calls=e.count,
            device_ms=e.self_device_time_total / 1e3)
    return (device_ms, sum(e.self_device_time_total for e in nccl) / 1e3,
            sum(e.count for e in nccl), max(0.0, 1.0 - device_ms / median_ms))


def phase_mesh_train(model_dir, root):
    """(a) the world-1 NCCL mesh through the CLI against the plain CLI run;
    (b) two gloo ranks on the card at --tp 2 and --dp 2. Returns (a)'s
    launch counts and (b)'s plain reference run (parallel_train's too)."""
    import torch
    import torch.distributed as dist

    from ultrafnd_git_tpu_torch.parallel import collectives as coll
    from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer

    argv = ["--model_dir", str(model_dir), "--batch_size", str(TRAIN_BATCH), "--epochs", "1",
            "--seed", "0", "--train_text_tower", "--text_tower_depth", str(TOWER["depth"]),
            "--text_tower_heads", str(TOWER["heads"]), "--tower_gelu", TOWER["gelu"],
            "--fused_adamw"]
    mesh_flags = ["--multihost", "--dp", "1", "--tp", "1", "--shard_corpus", "--shard_graph"]
    runs = {}
    train_step, init = ForensicTrainer.train_step, ForensicTrainer.__init__

    def timed_step(self, idx, mask):
        run = runs[self.cfg.out_dir]
        torch.cuda.synchronize()
        calls, s = coll.calls, time.perf_counter()
        result = train_step(self, idx, mask)
        run["losses"].append(float(result[0]))
        torch.cuda.synchronize()
        run["step_ms"].append(1e3 * (time.perf_counter() - s))
        run["collectives"].append(coll.calls - calls)
        return result

    def kept_init(self, cfg, *a, **kw):
        runs[cfg.out_dir] = {"losses": [], "step_ms": [], "collectives": [], "trainer": self}
        init(self, cfg, *a, **kw)

    env = {"JAX_COORDINATOR_ADDRESS": f"localhost:{_free_port()}", "JAX_NUM_PROCESSES": "1",
           "JAX_PROCESS_ID": "0"}
    ForensicTrainer.train_step, ForensicTrainer.__init__ = timed_step, kept_init
    try:
        plain_dir, mesh_dir = str(root / "plain_cli_run"), str(root / "mesh_cli_run")
        t0 = time.perf_counter()
        plain_results, _ = _train_cli(argv + ["--out_dir", plain_dir])
        plain_s = time.perf_counter() - t0
        os.environ.update(env)
        _reset_counts()  # this path's run only
        coll.calls = 0
        t1 = time.perf_counter()
        mesh_results, said = _train_cli(argv + ["--out_dir", mesh_dir] + mesh_flags)
        mesh_s = time.perf_counter() - t1
        launches = _launch_counts()
    finally:
        ForensicTrainer.train_step, ForensicTrainer.__init__ = train_step, init
        for k in env:
            os.environ.pop(k, None)
    plain, mesh = runs[plain_dir], runs[mesh_dir]
    pt, mt = plain["trainer"], mesh["trainer"]
    if mt.mesh is None or mt.mesh.backend != "nccl" or dist.get_world_size() != 1 \
            or "multi-host: no coordinator configured" not in said:
        raise RuntimeError(f"mesh_train (a) did not run a world of one over NCCL: {mt.mesh}")
    steps = len(mesh["losses"])
    chunks = sum(-(-len(s) // TRAIN_BATCH) for s in (mt.va_idx, mt.te_idx))
    depth = TOWER["depth"]
    expect = {"fwd": depth * (steps + chunks), "fwd_bf16": 0, "bwd": depth * steps,
              "bwd_bf16": 0, "adamw": steps + 2}
    if steps != -(-len(mt.tr_idx) // TRAIN_BATCH) or launches != expect:
        raise RuntimeError(f"mesh_train launches {launches} over {steps} steps, "
                           f"expected {expect}")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(mesh["losses"], plain["losses"])]
    rows = {d: [json.loads(ln) for ln in (Path(d) / "metrics.jsonl").read_text().splitlines()]
            for d in (plain_dir, mesh_dir)}
    for key in ("train_loss", "val_loss"):
        loss_rel.append(abs(rows[mesh_dir][0][key] - rows[plain_dir][0][key])
                        / abs(rows[plain_dir][0][key]))
    loss_rel.append(abs(mesh_results["test_loss"] - plain_results["test_loss"])
                    / abs(plain_results["test_loss"]))
    final = {name: {part: {k: v.cpu() for k, v in mod.state_dict().items()}
                    for part, mod in t.state.params.items()}
             for name, t in (("plain", pt), ("mesh", mt))}
    (leaf_rel, _), _ = _leaf_gaps(final["mesh"], final["plain"])
    identical = mesh["losses"] == plain["losses"] and all(
        torch.equal(final["mesh"][part][k], v) for part, sd in final["plain"].items()
        for k, v in sd.items())
    if len(mesh["losses"]) != len(plain["losses"]) or max(loss_rel) > MESH_REL \
            or leaf_rel > MESH_REL:
        raise RuntimeError(f"mesh_train (a): the mesh differs from the plain trainer: losses "
                           f"{max(loss_rel)}, parameters {leaf_rel} (bound {MESH_REL})")
    log("mesh_train", layout="(a) world 1, NCCL, CLI --multihost --dp 1 --tp 1 "
        "--shard_corpus --shard_graph", steps=steps,
        launches=json.dumps(launches, separators=(",", ":")),
        expected=json.dumps(expect, separators=(",", ":")),
        losses=json.dumps(mesh["losses"]), plain_losses=json.dumps(plain["losses"]),
        max_loss_rel=max(loss_rel), max_leaf_rel=leaf_rel, bit_identical=identical,
        collectives_a_step=json.dumps(mesh["collectives"]),
        cli_s=mesh_s, plain_cli_s=plain_s)

    # steps in turns on one batch: plain, mesh, mesh, plain
    chunk, mask, _ = mt.epoch_batches(mt.tr_idx, True)[0]
    times = {"plain": [], "mesh": []}
    calls = []
    for _ in range(3):
        for name, t in (("plain", pt), ("mesh", mt), ("mesh", mt), ("plain", pt)):
            torch.cuda.synchronize()
            c, s = coll.calls, time.perf_counter()
            t.train_step(chunk, mask)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - s))
            if name == "mesh":
                calls.append(coll.calls - c)
    med = {k: statistics.median(v) for k, v in times.items()}
    # the collectives' own time in one step: each all-reduce between two
    # synchronisations (host clock)
    all_reduce, spent = dist.all_reduce, []

    def timed_all_reduce(*a, **kw):
        torch.cuda.synchronize()
        s = time.perf_counter()
        out = all_reduce(*a, **kw)
        torch.cuda.synchronize()
        spent.append(1e3 * (time.perf_counter() - s))
        return out

    dist.all_reduce = timed_all_reduce
    try:
        mt.train_step(chunk, mask)
    finally:
        dist.all_reduce = all_reduce
    plain_device_ms, _, _, plain_idle = _profile_mesh_step(
        lambda: pt.train_step(chunk, mask), med["plain"], "plain")
    device_ms, nccl_ms, nccl_kernels, idle = _profile_mesh_step(
        lambda: mt.train_step(chunk, mask), med["mesh"], "mesh")
    log("mesh_train", median_step_ms=med["mesh"], plain_median_step_ms=med["plain"],
        samples_per_s=TRAIN_BATCH * 1e3 / med["mesh"], collectives_a_step=calls[0],
        collective_ms=json.dumps([round(x, 4) for x in spent]),
        step_device_ms=device_ms, plain_step_device_ms=plain_device_ms,
        nccl_ms=nccl_ms, nccl_kernels=nccl_kernels,
        device_idle_share=idle, plain_device_idle_share=plain_idle,
        turns=json.dumps({k: [round(x, 3) for x in v] for k, v in times.items()}))
    del pt, mt, runs
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b) two ranks on the card over gloo, each joining the group itself,
    # held against the plain trainer's first steps in this process
    gloo_cfg = dict(model_dir=str(model_dir), batch_size=TRAIN_BATCH, epochs=1, seed=0,
                    train_text_tower=True, text_tower_depth=TOWER["depth"],
                    text_tower_heads=TOWER["heads"], tower_gelu=TOWER["gelu"],
                    fused_adamw=True)
    ref = _plain_gloo_reference(gloo_cfg, root / "mesh_gloo_plain")
    for name, layout in MESH_GLOO_LAYOUTS:
        port, out = _free_port(), root / f"mesh_gloo_{name}"
        out.mkdir(parents=True, exist_ok=True)
        procs = []
        for r in range(2):
            penv = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                        JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(r), PYTHONPATH=str(REPO))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", MESH_GLOO_WORKER, json.dumps(layout),
                 json.dumps({**gloo_cfg, "out_dir": str(out)}), str(MESH_GLOO_STEPS)],
                cwd=REPO, env=penv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        t2 = time.perf_counter()
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, o in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"mesh_train (b) {name}: a rank failed:\n{o[-3000:]}")
        res = [json.loads(o.split("RESULT ")[-1].splitlines()[0]) for o in outs]
        gap = max(abs(a - b) for r in res for a, b in zip(r["losses"], mesh["losses"]))
        held = _hold_gloo_ranks(f"mesh_train (b) {name}", res, out, ref, MESH_GLOO_STEPS)
        if gap > MESH_GLOO_TOL:
            raise RuntimeError(f"mesh_train (b) {name}: losses {[r['losses'] for r in res]} "
                               f"vs (a) {mesh['losses'][:MESH_GLOO_STEPS]} (gap {gap}, bound "
                               f"{MESH_GLOO_TOL})")
        log("mesh_train", layout=f"(b) {name}, 2 gloo ranks on one card", ranks=json.dumps(
            [{"rank": r["rank"], "coords": r["coords"], "device": r["device"]} for r in res]),
            losses=json.dumps(res[0]["losses"]), max_gap_to_a=gap, **held,
            median_step_ms=statistics.median(res[0]["step_ms"][1:]),
            first_step_ms=res[0]["step_ms"][0], wall_s=time.perf_counter() - t2)
    return launches, ref


def _hold_gloo_ranks(what, res, out, ref, steps):
    """Two gloo ranks' results `res` (their losses, clip norms and replicated
    parameters' digest; their gathered parameters and AdamW moments in
    `out`/state.rank<r>.pt) held against the plain run `ref`: losses within
    MESH_GLOO_TOL, the norms and whole trees within MESH_REL relative, each
    moment leaf within MESH_LEAF_REL, both ranks alike. Raises naming
    `what`; returns the fields to log."""
    import torch

    plain_gap = max(abs(a - b) for r in res for a, b in zip(r["losses"], ref["losses"]))
    norm_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for r in res for a, b in zip(r["norms"], ref["norms"]))
    tree_rel, leaf_rel = {}, {}  # whole tree's relative L2; worst leaf's, and which
    for r in range(2):
        got = torch.load(out / f"state.rank{r}.pt", weights_only=True)
        for tree in ("params", "mu", "nu"):
            _, worst = _leaf_gaps(got[tree], ref[tree])
            leaf_rel[tree] = max(leaf_rel.get(tree, (0.0, "")), worst)
            tree_rel[tree] = max(tree_rel.get(tree, 0.0), _tree_gap(got[tree], ref[tree]))
    same = res[0]["replicated_sha256"] == res[1]["replicated_sha256"]
    if len(res[0]["losses"]) != steps or res[0]["losses"] != res[1]["losses"] \
            or len(res[0]["norms"]) != len(ref["norms"]) or len(ref["norms"]) < steps \
            or plain_gap > MESH_GLOO_TOL \
            or norm_rel > MESH_REL or max(tree_rel.values()) > MESH_REL \
            or max(leaf_rel["mu"][0], leaf_rel["nu"][0]) > MESH_LEAF_REL \
            or not same or res[0]["backend"] != "gloo":
        raise RuntimeError(
            f"{what}: losses {[r['losses'] for r in res]} vs the plain run "
            f"{ref['losses']} (gap {plain_gap}, bound {MESH_GLOO_TOL}); clip norms "
            f"{[r['norms'] for r in res]} vs {ref['norms']} (relative {norm_rel}); trees "
            f"{tree_rel} (bound {MESH_REL}); worst leaves {leaf_rel} (moments' bound "
            f"{MESH_LEAF_REL}); replicated parameters identical: {same}")
    return dict(max_gap_to_plain=plain_gap, clip_norms=json.dumps(res[0]["norms"]),
                max_norm_rel=norm_rel, tree_rel=json.dumps(tree_rel),
                worst_leaf_rel=json.dumps(leaf_rel), replicated_bit_identical=same)


def _spawn_ranks(script, args, world=2):
    """`world` processes of `script` joined through the --multihost env
    contract on a free local port; their (return codes, outputs), every
    process stopped on the way out."""
    port, procs = _free_port(), []
    for r in range(world):
        penv = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                    JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(r), PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen([sys.executable, "-c", script, *args], cwd=REPO, env=penv,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [p.returncode for p in procs], outs


def phase_parallel_train(model_dir, served, moe_served, root, ref, requests):
    """--sp 2, --pp 2 and --pp 2 --pp_microbatches 4 on two gloo ranks
    sharing the card, PARALLEL_STEPS steps each, held against the plain
    run `ref` (mesh_train's); the MoE block with its experts cut over an
    ep group of the two ranks against the whole block; serve_dp on this
    process's cards. Returns the path's launch counts (the ranks', then
    this process's serve_dp requests)."""
    import torch

    from ultrafnd_git_tpu_torch.serving import Predictor

    t0 = time.perf_counter()
    cfg = dict(model_dir=str(model_dir), batch_size=TRAIN_BATCH, epochs=1, seed=0,
               train_text_tower=True, text_tower_depth=TOWER["depth"],
               text_tower_heads=TOWER["heads"], tower_gelu=TOWER["gelu"], fused_adamw=True,
               out_dir=str(root / "parallel"))
    rcs, outs = _spawn_ranks(PARALLEL_WORKER, [json.dumps(PARALLEL_LAYOUTS), json.dumps(cfg),
                                               str(PARALLEL_STEPS), json.dumps(MOE_EP)])
    for rc, o in zip(rcs, outs):
        if rc != 0:
            raise RuntimeError(f"parallel_train: a rank failed:\n{o[-3000:]}")
    launches = dict.fromkeys(("fwd", "fwd_bf16", "bwd", "bwd_bf16", "adamw"), 0)
    for name, layout in PARALLEL_LAYOUTS:
        res = [json.loads(o.split(f"RESULT {name} ")[-1].splitlines()[0]) for o in outs]
        held = _hold_gloo_ranks(f"parallel_train {name}", res, root / "parallel" / name, ref,
                                PARALLEL_STEPS)
        steps = res[0]["steps_run"]
        if "pp" in layout:  # each rank's blocks, once a microbatch
            k2 = steps * layout.get("pp_microbatches", layout["pp"]) * TOWER["depth"] \
                // layout["pp"]
        else:  # the ring is plain torch
            k2 = 0
        expect = {"fwd": k2, "fwd_bf16": 0, "bwd": k2, "bwd_bf16": 0, "adamw": steps + 2}
        for r in res:
            if r["launches"] != expect:
                raise RuntimeError(f"parallel_train {name}: rank {r['rank']} launched "
                                   f"{r['launches']}, expected {expect}")
            for k, v in r["launches"].items():
                launches[k] += v
        log("parallel_train", layout=f"{name} {json.dumps(layout)}, 2 gloo ranks on one card",
            ranks=json.dumps([{"rank": r["rank"], "coords": r["coords"]} for r in res]),
            losses=json.dumps(res[0]["losses"]), plain_losses=json.dumps(ref["losses"]), **held,
            median_step_ms=json.dumps([r["median_step_ms"] for r in res]),
            first_step_ms=res[0]["step_ms"][0],
            step_device_ms=json.dumps([r["step_device_ms"] for r in res]),
            device_idle_share=json.dumps([r["idle_share"] for r in res]),
            ring_forward_kernel_ms=json.dumps([r["ring_forward_kernel_ms"] for r in res]),
            ring_forward_copy_ms=json.dumps([r["ring_forward_copy_ms"] for r in res]),
            collectives_a_step=res[0]["collectives_a_step"],
            collective_ms=json.dumps([round(x, 3) for x in res[0]["collective_ms"]]),
            launches_a_rank=json.dumps(res[0]["launches"], separators=(",", ":")),
            top_kernels=json.dumps(res[0]["top_kernels"]))
    moe = [json.loads(o.split("MOE ")[-1].splitlines()[0]) for o in outs]
    worst = max(max(m["y_rel"], m["aux_rel"], m["dx_rel"], m["grad_rel"]) for m in moe)
    if worst > MOE_EP_REL or moe[0]["expert_shapes"][0][0] != MOE_EP["experts"] // 2:
        raise RuntimeError(f"parallel_train ep: the sharded MoE block differs from the whole "
                           f"one: {moe}")
    for m in moe:
        for k, v in m["launches"].items():
            launches[k] += v
    log("parallel_train", check="MoE block (width 768, 8 experts) with its experts cut over "
        "ep = 2 vs the whole block", shape=json.dumps(MOE_EP), worst_rel=worst,
        ranks=json.dumps(moe))

    # serve_dp on this process's cards
    _reset_counts()
    requests = [requests[0], requests[-1]]  # 8 and 300 records
    single = Predictor(str(served))
    rows = {"single": [single.predict(r) for r in requests]}
    one = Predictor(str(served), serve_dp=1)
    rows["serve_dp=1"] = [one.predict(r) for r in requests]
    gaps = {"serve_dp=1": _max_gap(rows["serve_dp=1"], rows["single"])}
    cards = torch.cuda.device_count()
    try:
        Predictor(str(served), serve_dp=cards + 1)
        raise RuntimeError(f"parallel_train: serve_dp={cards + 1} did not raise on {cards} card(s)")
    except ValueError as exc:
        refused = str(exc)
    if cards >= 2:
        multi = Predictor(str(served), serve_dp=cards)
        rows[f"serve_dp={cards}"] = [multi.predict(r) for r in requests]
        gaps[f"serve_dp={cards}"] = _max_gap(rows[f"serve_dp={cards}"], rows["single"])
        multi.close()
    for p in (single, one):
        p.close()
    if gaps["serve_dp=1"] != 0.0 or max(gaps.values()) > 1e-6:
        raise RuntimeError(f"parallel_train serve_dp: rows differ from the single Predictor's: "
                           f"{gaps}")
    # a switch-MoE tower: every bucket whole on replica 0, the single Predictor's rows
    moe_rows = {}
    for label, dp in (("single", None), (f"serve_dp={cards}", cards)):
        pred = Predictor(str(moe_served), serve_dp=dp)
        moe_rows[label] = [pred.predict(r) for r in requests]
        pred.close()
    moe_gap = _max_gap(moe_rows[f"serve_dp={cards}"], moe_rows["single"])
    if moe_gap != 0.0:
        raise RuntimeError(f"parallel_train serve_dp: the MoE export at serve_dp={cards} "
                           f"differs from the single Predictor by {moe_gap}")
    for k, v in _launch_counts().items():
        launches[k] += v
    log("parallel_train", check="serve_dp", cards=cards, max_gap=json.dumps(gaps),
        moe_serve_dp=cards, moe_max_gap=moe_gap,
        refused=json.dumps(refused), ran_multi_card=cards >= 2,
        launches=json.dumps(launches, separators=(",", ":")),
        phase_wall_s=time.perf_counter() - t0, script_wall_s=time.perf_counter() - T0)
    return launches


def main() -> int:
    dev = phase_device()
    import torch

    from ultrafnd_git_tpu_torch.utils.transfer import export_trained

    (REPO / "build").mkdir(exist_ok=True)
    ptxas = phase_build()
    flash = check_flash(dev)
    flash_bf16 = check_flash_bf16(dev)
    bwd_bf16 = check_flash_bwd_bf16(dev, flash["dq"]["ms"])
    k1 = check_adamw(dev)
    gemm = check_gemm_tf32x3(dev)
    pp_shapes = check_pipeline_shapes(dev)
    hf_twins = phase_hf_twins(dev)
    lm_rung = phase_lm_rung(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=REPO / "build") as root:
        seeded, served = Path(root) / "seeded_model", Path(root) / "trained_model"
        corpus = build_model_dir(str(seeded))
        rng = np.random.default_rng(1)
        requests = [synthetic_records(n, corpus, rng) for n in REQUEST_SIZES]
        train = phase_train(dev, seeded, Path(root) / "run")
        bf16 = phase_train(dev, seeded, Path(root) / "bf16_run", bf16=True,
                           f32_step_ms=train["median_step_ms"])
        bf16_served = Path(root) / "bf16_model"
        export_trained(str(Path(root) / "bf16_run"), "best", str(bf16_served), str(seeded))
        phase_bf16_serve(str(bf16_served), requests)
        export_trained(str(Path(root) / "run"), "best", str(served), str(seeded))
        serve = phase_serve(str(served), requests)
        levers = phase_serve_levers(str(served), requests, serve)
        explain = phase_explain(str(served), requests[0])
        http = phase_http(str(served), requests, corpus)
        sparse = phase_train(dev, seeded, Path(root) / "sparse_run", sparse_graph=True)
        log("sparse", median_step_ms=sparse["median_step_ms"],
            dense_median_step_ms=train["median_step_ms"])
        sparse_served = Path(root) / "sparse_model"
        export_trained(str(Path(root) / "sparse_run"), "best", str(sparse_served), str(seeded))
        phase_sparse_serve(str(sparse_served), requests)
        moe = phase_moe_train(seeded, Path(root) / "moe_run", train["median_step_ms"])
        moe_served = Path(root) / "moe_model"
        export_trained(str(Path(root) / "moe_run"), "best", str(moe_served), str(seeded))
        moe_serve = phase_moe_serve(str(moe_served), requests)
        moe_resume = phase_moe_resume(seeded, Path(root))
        raw = phase_raw_train(Path(root))
        rng = np.random.default_rng(5)
        migration = phase_reference_migration(
            Path(root), raw, [raw_records(n, rng, f"r{n}") for n in REQUEST_SIZES])
        rng = np.random.default_rng(4)
        text_tower = phase_text_tower(raw["data_root"], raw["out_dir"], raw["exported"],
                                      [raw_records(n, rng, f"t{n}") for n in REQUEST_SIZES])
        rng = np.random.default_rng(3)
        evidence = phase_evidence_serve(
            str(raw["exported"]), [raw_records(n, rng, f"q{n}") for n in REQUEST_SIZES])
        salt = phase_auto_salt(raw["data_root"], Path(root))
        artifact = phase_artifact_serve(str(served), requests, serve, Path(root))
        legacy = phase_legacy_serve(str(served), requests)
        integrated = phase_integrated_train(raw["data_root"], Path(root))
        v1_train = phase_v1_train(dev, Path(root))
        mesh_train, plain_ref = phase_mesh_train(seeded, Path(root))
        parallel_train = phase_parallel_train(seeded, served, moe_served, Path(root), plain_ref,
                                              requests)

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("ultrafnd_git_tpu", "jax", "jaxlib", "flax"))
    if loaded:
        raise RuntimeError(f"the run loaded modules of jax or the JAX package: {loaded[:10]}")
    src = "ultrafnd_git_tpu_torch/csrc/"
    ref = "ultrafnd_git_tpu/kernels/"
    tl, bl, sl, rl = train["launches"], bf16["launches"], sparse["launches"], raw["launches"]

    def paths(key, serve_n=0, levers_n=0, explain_n=0, http_n=0, evidence_n=0, legacy_n=0):
        by = {"train": tl[key], "bf16_train": bl[key], "serve": serve_n,
              "serve_levers": levers_n, "explain": explain_n, "http": http_n,
              "sparse_train": sl[key], "raw_train": rl[key], "evidence_serve": evidence_n,
              "moe_train": moe["launches"][key], "moe_resume": moe_resume[key],
              "moe_serve": moe_serve["launches"].get(key, 0), "auto_salt": salt[key],
              "artifact_serve": artifact.get(key, 0), "legacy_serve": legacy_n,
              "integrated_train": integrated[key], "text_tower": text_tower["launches"][key],
              "v1_train": v1_train[key], "mesh_train": mesh_train[key],
              "parallel_train": parallel_train[key], "reference_migration": migration[key],
              "hf_twins": hf_twins["launches"].get(key, 0)}
        return {"launches": sum(by.values()), "launches_by_path": by}

    print(json.dumps({"kernels": [
        {"name": "adamw", "route": "cuda", "source": src + "adamw.cu",
         "replaces": ref + "adamw.py:114", **paths("adamw"), **k1, "ptxas": ptxas["adamw"]},
        {"name": "flash_attention_fwd", "route": "cuda", "source": src + "flash_attention_fwd.cu",
         "replaces": ref + "flash_attention.py:162",
         **paths("fwd", serve["launches"], levers["fwd"], explain, http, evidence, legacy),
         **flash["fwd"], "pipelined_shapes": pp_shapes["fwd"],
         "hf_twin_shapes": hf_twins["k2_shapes"], "ptxas": ptxas["flash_attention_fwd"]},
        {"name": "flash_attention_fwd_bf16", "route": "cuda",
         "source": src + "flash_attention_fwd_bf16.cu",
         "replaces": ref + "flash_attention.py:162 (mm_dtype=bfloat16)",
         **paths("fwd_bf16", levers_n=levers["fwd_bf16"]), **flash_bf16,
         "ptxas": ptxas["flash_attention_fwd_bf16"]},
        {"name": "flash_attention_fwd_bf16_causal", "route": "cuda",
         "source": src + "flash_attention_fwd_bf16.cu",
         "replaces": "none (the LM rung's causal attention; the JAX package has no LM rung)",
         "launches": lm_rung["launches"]["fwd_bf16_causal"],
         "launches_by_path": {"lm_rung": lm_rung["launches"]["fwd_bf16_causal"]},
         "ptxas": ptxas["flash_attention_fwd_bf16"]},
        {"name": "gemm_tf32x3", "route": "cuda", "source": src + "gemm_tf32x3.cu",
         "replaces": "none (the JAX package leaves these products to XLA)",
         "launches": hf_twins["gemm_launches"],
         "launches_by_path": {"hf_twins": hf_twins["gemm_launches"]}, **gemm,
         "ptxas": ptxas["gemm_tf32x3"]},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": src + "flash_attention_bwd.cu", "replaces": ref + "flash_attention.py:379",
         **paths("bwd"), **flash["dq"], "pipelined_shapes": pp_shapes["bwd"],
         "ptxas": ptxas["flash_attention_bwd"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": src + "flash_attention_bwd.cu", "replaces": ref + "flash_attention.py:412",
         **paths("bwd"), **flash["dkv"], "pipelined_shapes": pp_shapes["bwd"],
         "ptxas": ptxas["flash_attention_bwd"]},
        {"name": "flash_attention_bwd_dq_bf16", "route": "cuda",
         "source": src + "flash_attention_bwd_bf16.cu",
         "replaces": ref + "flash_attention.py:379 (mm_dtype=bfloat16)",
         **paths("bwd_bf16"), **bwd_bf16, "pipelined_shapes": pp_shapes["bwd_bf16"],
         "ptxas": ptxas["flash_attention_bwd_bf16"]},
        {"name": "flash_attention_bwd_dkv_bf16", "route": "cuda",
         "source": src + "flash_attention_bwd_bf16.cu",
         "replaces": ref + "flash_attention.py:412 (mm_dtype=bfloat16)",
         **paths("bwd_bf16"), **bwd_bf16, "pipelined_shapes": pp_shapes["bwd_bf16"],
         "ptxas": ptxas["flash_attention_bwd_bf16"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
