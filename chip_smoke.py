"""Chip smoke for the PyTorch/CUDA port (analytics_zoo_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``analytics_zoo_tpu_torch/csrc``
and holds each kernel against its plain PyTorch version on the card. Then,
with a BERT-Base classifier (google-research/bert's BERT-Base, Uncased
widths: vocab 30522, hidden 768, 12 layers, 12 heads, intermediate 3072,
512 positions; seeded random weights), it

* serves 256 requests through ``InferenceModel`` and ``ClusterServing``
  (phases ``serve``, ``profile``): the answers went through the flash
  forward kernel and match the same weights run on the CPU;
* trains 16 steps through ``BERTClassifier.fit`` (phases ``train``,
  ``profile_train``): every layer's attention runs the forward and both
  backward kernels; ``evaluate`` and ``predict`` follow;
* takes 2 training steps on the card and on the CPU from the same weights
  (phase ``train_vs_cpu``): losses and first-step gradients agree.

Then, with the NCF flagship at MovieLens-1M widths (6040 users, 3706 items,
5 rating classes, embeddings 64 + 64, MLP (128, 64, 32), bf16 compute,
batch 262,144; seeded random pairs as in ``bench.py``'s ``bench_ncf``), it

* trains 2 epochs of 8 steps through ``NeuralCF.fit`` with the
  checkpoint plane (an every-epoch trigger into a temporary ``model_dir``)
  and the prefetching infeed, then restores the checkpoint into a fresh
  model whose ``evaluate`` loss must equal the trained one's (``ncf_train``);
* profiles training steps with prefetch on and off (``ncf_profile``);
* takes 2 steps on the card and on the CPU from the same weights, in f32
  and in bf16 (``ncf_vs_cpu``);
* holds the embedding's one-hot backward (an f32 row sum) against the
  one-hot matmul it replaces, and times both (``embed_bwd``).

Then, with ResNet-50 v1.5 at bench.py's ``bench_resnet50`` configuration
(1000 classes, batch 256, crop 224 out of 232 px uint8 images, bf16
compute, SGD with momentum 0.9 under Warmup -> Poly; 2048 seeded synthetic
images, seeded random weights), it

* trains 2 epochs of 8 steps through ``TPUEstimator.fit`` over the
  streaming ``ImageNetPipeline`` with the checkpoint plane, holds each
  step's lr to the schedule's, and restores the checkpoint into a fresh
  model whose ``evaluate`` loss must equal the trained one's
  (``resnet_train``);
* profiles training steps: device time by class, idle share, step FLOPs
  and MFU (``resnet_profile``);
* takes 2 steps on the card and on the CPU from the same weights, in f32
  and in bf16, and the f32 steps again with the CPU's ReLU masks and
  max-pool choices imposed on the card (``resnet_vs_cpu``).

Then, with a user's torch ResNet-50 (torchvision's v1.5 layout written in
plain torch, ``TorchResNet`` below: 25,557,032 parameters, 1000 classes,
224 px, batch 256, f32 with TF32 off; 1,024 seeded synthetic images;
torch.optim.SGD with momentum 0.9 and nn.CrossEntropyLoss), BASELINE
config #2's entry point, it

* trains 2 epochs of 4 steps through ``Estimator.from_torch`` and a
  ``data_creator`` returning a DataLoader, with an every-epoch checkpoint,
  then restores it into a fresh estimator whose ``evaluate`` loss and
  ``predict`` logits must equal the trained one's (``torch_estimator_train``);
* profiles training steps: device time by class, idle share, step FLOPs
  against the f32 peak (``torch_estimator_profile``);
* takes 2 steps on the card and on the CPU from the same weights
  (``torch_estimator_vs_cpu``);
* trains an epoch through a ``TrainingOperator`` subclass
  (``torch_operator_fit``), and an epoch over 4-partition XShards whose
  batch stream equals the concatenated arrays' and whose ``predict``
  returns XShards (``torch_xshards_fit``).

Then, with the fraud-detection MLP of BASELINE #3 (bench.py's
``bench_fraud_mlp``: 29 features, Keras Dense 256 -> 128 -> 64 -> 1,
binary cross-entropy, Adam, f32, batch 16,384; the fraud example's
synthetic data, 100,000 rows, 2 % fraud), it

* trains 3 epochs through ``NNEstimator(Sequential(...).to_module(),
  "binary_crossentropy").fit(df)`` and scores the 10 % holdout through
  ``NNModel.transform``, whose AUC is held against the JAX package's and
  the port's CPU readings (``fraud_nnframes_train``; no flash kernel
  launches on this path, and the ``kernels`` line says so);
* profiles training steps: device time by class, idle share, step FLOPs
  (``fraud_profile``);
* takes 2 steps on the card and on the CPU from the same weights
  (``fraud_vs_cpu``);
* trains the same MLP through the Keras API over ``read_csv`` XShards of 4
  CSV files in Kaggle's schema, with TensorBoard summaries, ``predict`` on
  XShards and a ``save_weights``/``load_weights`` round trip
  (``keras_csv_fit``);
* takes 3 steps with each of Adagrad, Adadelta, Adamax, RMSprop and Ftrl
  on the card and on the CPU (``optimizers_vs_cpu``).

Then, with Zouwu's AutoTS at bench.py's ``bench_autots_trials``
configuration (BASELINE #4: 2000 hourly points of a noisy daily sine, an
LSTM and a TCN grid-random search of 4 trials each on TPUSearchEngine's
device leases), it

* runs a warm-up round and 3 timed rounds through ``AutoTSTrainer.fit``:
  every trial ends ``done`` on cuda:0 with the config the engine's seed
  gives, trials/hour from the best round; each winner's ``TSPipeline``
  predicts, evaluates, saves and loads (``autots_trials``; no flash kernel
  launches on this path);
* profiles an LSTM and a TCN trial's steps at batch 64
  (``autots_profile``);
* takes 2 Adam steps of the LSTM, TCN, Seq2Seq and MTNet forecasters on
  the card and on the CPU (``zouwu_vs_cpu``, cuDNN's LSTM in f32);
* holds MTNetLite to the NYC-taxi gate of tests/test_zouwu_real_data.py
  (``zouwu_real_data``);
* searches lr and batch size for a torch MLP through
  ``AutoEstimator.from_torch`` (``auto_estimator_search``);
* runs each recipe at 10 trials and 9 epochs under the ASHA
  ``TrialRuntime`` (``scheduler="asha"``, rungs [1, 3, 9]) and
  exhaustively: fewer than half the epochs, the winner within 1.5x of the
  exhaustive best, every trial in the study's event log and manifest
  (``asha_autots``);
* pauses a ``TrialModel`` at epoch 2, checkpoints it to disk through the
  checkpoint plane and resumes it bit for bit (with an off-by-one
  control), and sends an ASHA study SIGTERM from a report hook, resumes
  it from its manifest through a fresh ``AutoEstimator`` and holds its
  rung ledger and winner to an uninterrupted study's (``asha_resume``);
* stops the fraud MLP's ``TPUEstimator.fit`` by SIGTERM at iteration 10
  and restores its checkpoint bit for bit (``estimator_preemption``);
* searches ``AutoXGBRegressor`` and ``AutoXGBClassifier`` on the card's
  lease against a CPU run (``auto_xgb``; no flash kernel launches on any
  of these four paths).

Then, with SSD object detection served through Cluster Serving, BASELINE
#5 (``examples/serving/object_detection_serving.py``, bench.py's
``bench_serving_od``: SSD300 at 300 px, 21 classes, bf16 trunk, batch 64,
100 detections; seeded random weights and images), it

* serves 512 f32 requests over ``InMemoryBroker`` and 256 uint8 requests
  over ``RedisBroker`` on ``MiniRedisServer`` through a prologue on the
  card, then ``bench_serving_od``'s ``ssd_tiny`` shape (128 px, 3
  classes) over both, through ``ObjectDetector.as_inference_model`` and
  ``ClusterServing`` (``od_serve``; no flash kernel on this path);
* times a served batch's trunk against its decode + NMS and profiles it:
  idle share, kernels a batch, the NMS loop's share, MFU (``od_profile``);
* holds loc/conf on the card against the CPU in f32, the postprocessor on
  the same loc/conf, the bf16 trunk against f32 and ``quantize()``'s int8
  weights against f32 (``od_vs_cpu``);
* trains ``ssd_tiny`` through ``ObjectDetector.fit`` while a live server
  watches the checkpoint root, and checks the hot swap, the served
  answers against ``predict_image_set`` and encrypted models
  (``od_hot_reload``).

Each phase prints one JSON line; any failure raises and exits non-zero.
The ``kernels`` line lists every kernel with its time, bound, plain and
library times; the last line is ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""

import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEQ = 128                   # request length: token ids, no input mask
N_REQUESTS = 256
BATCH = 32
N_CPU_CHECK = 8             # requests re-run on the CPU for the logits check
# Kernel vs plain tolerances. f32: both sum in f32 in a different order
# (the kernels take their products in 3xTF32 on the tensor cores, which
# keeps f32 accuracy, but the tensor cores' accumulation truncates);
# measured errors are up to 5e-6 on outputs of magnitude <= 4.
# bf16: the output is rounded to bf16 on both sides, so one ulp (2^-8
# relative, 1.6e-2 at 4) may separate them. lse2 is f32 on both sides.
TOL_F32 = 1e-5
TOL_BF16 = 2e-2
TOL_LSE = 1e-5
# Served (card) vs CPU logits, both f32 with TF32 off: the two differ by
# the summation order of every matmul and of the attention through 12
# layers (measured ~6e-7 on logits of magnitude ~0.6).
TOL_SERVED = 1e-4
# Backward kernels vs plain, relative to each gradient's largest magnitude
# (the gradients are sums over up to 2048 keys or queries). f32: both
# sum in f32 in another order. bf16: both round the result to bf16 (2^-8
# relative) from f32 sums of the same inputs. The same 1e-5 holds the
# kernels against autograd through mha_reference in f32.
TOL_BWD = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# Training: 256 rows of 128 ids, batch 32, 2 epochs = 16 steps.
TRAIN_ROWS, TRAIN_EPOCHS = 256, 2
# Card vs CPU training steps, f32 with TF32 off on both: the losses differ
# by the summation order of 12 layers forward (rtol 1e-5), the first-step
# gradients by that order forward and backward, relative to each
# parameter's largest gradient (1e-3: a gradient is a difference of
# nearly equal sums, so its low bits carry the forward's rounding).
TOL_STEP_LOSS = 1e-5
TOL_STEP_GRAD = 1e-3
# Peaks of one H100 SXM (NVIDIA data sheet, dense): TF32 and BF16 on the
# tensor cores, FP32 outside them, HBM3 bandwidth. An f32 product at f32
# accuracy on the tensor cores takes three TF32 passes (3xTF32), so the
# least time for f32 work is 3 * flops / 495 TFLOP/s; bf16 is one pass.
# The CUDA-core figure is kept as a second bound (``bound_cuda_cores_ms``).
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_F32_CUDA_CORES = 67e12
PEAK_BYTES = 3.35e12
TIMING_ROUNDS = 9           # rounds of kernel / library timed in turns
# NCF flagship (bench.py bench_ncf): MovieLens-1M counts, full widths
NCF_WIDTHS = dict(user_count=6040, item_count=3706, class_num=5,
                  user_embed=64, item_embed=64, mf_embed=64,
                  hidden_layers=(128, 64, 32))
NCF_BATCH = 262144
NCF_ROWS = 8 * NCF_BATCH            # 8 steps an epoch
NCF_EPOCHS = 2
NCF_PROFILE_STEPS = 4
NCF_CPU_BATCH = 16384               # card vs CPU steps: full widths
# Card vs CPU NCF steps. f32 (TF32 off on both): BERT's tolerances for the
# losses and the MLP's and head's first-step gradients, and TOL_STEP_GRAD
# for the cotangents that reach the two embedding backwards. Each table's
# gradient is held to TOL_EMBED_BWD against the plain one-hot matmul applied
# to the card's own ids and cotangents; the card-vs-CPU table gradients are
# reported, not held (the backward rounds each cotangent to bf16, as the JAX
# package does, so f32 cotangents a few f32 ulps apart can round one bf16
# ulp apart; the phase counts those flips).
# bf16 compute, the flagship: the losses within 1e-2 (they stay near ln 5
# at these steps whatever the MLP computes, so they cannot tell bf16 from
# f32), and the first-step gradients per class, each limit between the card
# vs CPU reading in bf16 and the control, the card's f32-compute gradients
# against the CPU's bf16 ones, which must miss every limit (readings on an
# H100 80GB HBM3 at 700 W, sound / control: MLP <= 5.6e-3 / >= 7.4e-2;
# head kernel 8.8e-5 / 4.0e-3, head bias 7.7e-7 / 6.8e-4; cotangents
# 5.2e-2 and 7.4e-2 / 0.32 and 0.27).
TOL_NCF_BF16_LOSS = 1e-2
TOL_NCF_BF16_GRAD = {"mlp": 2e-2, "head": 2e-4, "cotangent": 0.15}
# The one-hot backward as a row sum against the one-hot matmul: both sum
# the same bf16-rounded cotangents in f32, in different orders.
TOL_EMBED_BWD = 1e-6
EMBED_BWD_CHECK_IDS = 16384         # the one-hot fits at this batch
# ResNet-50 (bench.py bench_resnet50): 1000 classes, crop 224 out of 232 px
# uint8 images, batch 256, SGD momentum 0.9 under Warmup -> Poly with the
# reference recipe's peak 0.1 * batch / 256, bf16 compute; 2048 seeded
# synthetic images (ImageNet is not in the repository), 2 epochs of 8 steps
RESNET = dict(depth=50, classes=1000, images=2048, image_size=232,
              crop=224, batch=256, shard_size=1024, epochs=2)
RESNET_PROFILE_STEPS = 4
RESNET_CPU_BATCH = 8                # card vs CPU steps: full widths
# Card vs CPU ResNet-50 steps: the losses (relative), the first-step
# gradients by class (the largest error of a parameter relative to its
# largest gradient) and the BatchNorm statistics after step 2 (likewise).
# Each limit but the losses' sits between the card-vs-CPU reading and a
# control that must miss it: for f32 (TF32 off on both) the card's bf16
# run against the CPU's f32 one, for bf16 the card's f32 run against the
# CPU's bf16 one. The losses stay near ln(1000) after two steps whatever
# the compute, so no control is asked of them. The f32 gradients of the
# convs and BatchNorms are not held to BERT's 1e-3: ReLU outputs whose f32
# pre-activation lies within rounding of 0 are 0 on one side and not on
# the other (the phase counts them), and each moves one term of a 7x7
# stage's per-channel sums of 392 (readings on an H100 80GB HBM3 at 700 W,
# reading / control: f32 conv 4.5e-2 / 0.30, BatchNorm 7.7e-2 / 0.27,
# head 9.7e-7 / 1.2e-2, statistics 3.1e-6 / 7.5e-3; bf16 conv 0.18 /
# 0.30, BatchNorm 0.14 / 0.27, head 5.6e-3 / 1.2e-2, statistics 7.3e-4 /
# 7.5e-3; 10 distinct ReLU flips in the first step's 76,869,632 ReLU
# outputs). The witness that those flips make the whole f32 difference:
# the card's f32 steps again with the CPU's ReLU masks and max-pool
# choices imposed, held to BERT's f32 limits in every class (reading:
# loss 1.4e-7, statistics 9.9e-7, conv 3.4e-6, BatchNorm 3.3e-5, head
# 9.7e-7).
TOL_RESNET = {
    "float32": {"loss": TOL_STEP_LOSS, "stats": 1e-4, "grad_head": 1e-3,
                "grad_conv": 0.1, "grad_batch_norm": 0.1},
    "float32_switches_imposed": {
        "loss": TOL_STEP_LOSS, "stats": 1e-4, "grad_head": TOL_STEP_GRAD,
        "grad_conv": TOL_STEP_GRAD, "grad_batch_norm": TOL_STEP_GRAD},
    "bfloat16": {"loss": 1e-3, "stats": 2.5e-3, "grad_head": 8e-3,
                 "grad_conv": 0.24, "grad_batch_norm": 0.2}}

# A user's torch ResNet-50 through Estimator.from_torch, BASELINE config #2's
# entry point ("Orca PyTorch Estimator: ResNet-50"): torchvision's layout in
# plain torch (TorchResNet below), 1000 classes, 224 px, batch 256, f32
# (TF32 off, the port's policy), torch.optim.SGD with momentum 0.9 and
# nn.CrossEntropyLoss; 1,024 seeded synthetic images from a DataLoader, 2
# epochs of 4 steps.
TORCH_RESNET = dict(images=1024, size=224, classes=1000, batch=256,
                    epochs=2)
TORCH_RESNET_PARAMS = 25557032
TORCH_PROFILE_STEPS = 3
TORCH_CPU_BATCH = 8                 # card vs CPU steps: full widths
TORCH_XSHARDS_IMAGES, TORCH_XSHARDS_BATCH = 512, 128
# Card vs CPU from_torch steps (f32, TF32 off on both): a step's loss
# (relative) and the BatchNorm statistics after it (the largest error of a
# buffer relative to its largest value), at resnet_vs_cpu's f32 limits;
# the control, the card's steps with the two batches swapped, must miss
# both. From torch's default init (every BatchNorm scale 1) the f32
# backward of this network is ill-conditioned, so the second step's loss
# and statistics move with f32 rounding itself: only the first step is
# held there, and the second is reported beside the CPU's own f32-vs-f64
# reading (readings on an H100 80GB HBM3 at 700 W, card vs CPU / CPU f32
# vs f64: loss 1.1e-3 / 1.7e-4, statistics 3.8e-2 / 3.4e-2). With each
# bottleneck's last BatchNorm scale at 0 (torchvision's
# zero_init_residual) the backward is well-conditioned and the second
# step is held (reading: loss 6.5e-8, statistics 3.9e-6; swapped control
# 4.6e-3, 2.1e-2).
TOL_TORCH_RESNET = {"loss": TOL_STEP_LOSS, "stats": 1e-4}

# The fraud-detection MLP of BASELINE #3 (bench.py's bench_fraud_mlp):
# 29 float features, Keras Dense 256 -> 128 -> 64 -> 1 (ReLU, sigmoid),
# binary cross-entropy, NNEstimator's default Adam, f32 (TF32 off), batch
# 16,384, 3 epochs; the data is examples/nnframes/fraud_detection_mlp.py's
# synthetic_fraud (100,000 rows from seed 0, 2 % fraud, +1.5 on five
# features) with its 10 % holdout.
FRAUD = dict(rows=100_000, features=29, fraud_rate=0.02, seed=0,
             widths=(256, 128, 64), batch=16384, epochs=3, holdout=0.1)
FRAUD_PROFILE_STEPS = 3
# Holdout AUC (the example's rank formula; 196 fraud rows of 10,000, where
# an untrained ranking reads 0.5 +- 0.021), held two ways, with readings
# of scripts/fraud_auc_reference.py on the CPU. The JAX package's run
# (NNEstimator, seed 0) reads FRAUD_AUC_JAX. It starts from other random
# weights (JAX's PRNG is not torch's), and after 18 Adam steps the AUC
# still spreads with the initial weights: JAX seeds 0-4 read 0.671-0.781,
# port seeds 0-9 read 0.598-0.844. So the card's AUC must be at least
# FRAUD_AUC_JAX - FRAUD_AUC_MARGIN. The port's run on the CPU from the
# card's initial weights (torch seed 0, drawn on the CPU) reads
# FRAUD_AUC_PORT_CPU; the card's must be within FRAUD_AUC_SAME of it.
FRAUD_AUC_JAX = 0.7692835702212342
FRAUD_AUC_PORT_CPU = 0.7506801680280435
FRAUD_AUC_MARGIN = 0.15
FRAUD_AUC_SAME = 0.02
# Card vs CPU fraud steps (f32, TF32 off on both): a step's loss
# (relative) and gradients (the largest error of a parameter's gradient
# relative to its largest entry; sums over 16,384 rows in another order).
TOL_FRAUD = {"loss": TOL_STEP_LOSS, "grad": 1e-4}
# Card vs CPU optimizer steps: the losses, and the parameter updates
# relative to each parameter's largest update (see _update_readings), at
# 1e-3. Two effects put updates above the gradients' own error (3.9e-7 of
# the largest in fraud_vs_cpu). From the second step the two sides'
# parameters differ in their last bits, so a ReLU whose pre-activation
# sits within that of 0 in one of 16,384 rows may flip, and that row's
# share of the gradient (~1/16,384 = 6e-5) changes. And Adadelta's first
# update, g * sqrt(eps) / sqrt(0.1 g^2 + eps) (eps 1e-10, lr 1), is g
# itself for |g| << 1e-4 but saturates at sqrt(10 eps) = 3.2e-5, so a
# small gradient's error passes whole while the largest update stays
# 3.2e-5 (~2.5e-4 of it at gradients of ~0.02). Readings on an H100 80GB
# HBM3 at 700 W: Adagrad 8.3e-5, Adadelta 2.4e-4, Adamax 7.5e-6, RMSprop
# 7.6e-6, Ftrl 4.0e-5; the swapped control 0.15 or more.
TOL_OPTIMIZERS = {"loss": TOL_STEP_LOSS, "update": 1e-3}
# The Keras API over read_csv: 65,536 rows of Kaggle's creditcard.csv
# schema in 4 files, batch 16,384, 2 epochs.
KERAS_CSV = dict(rows=65536, files=4, batch=16384, epochs=2)
# Zouwu AutoTS, BASELINE #4 (bench.py's bench_autots_trials at full size):
# 2000 hourly points of sin(2 pi t / 24) + 0.1 N(0, 1) (RandomState(0)),
# horizon 1, past 50 (the recipes' only choice), 6 features a step (the
# value and five datetime features); each round an LSTM search
# (LSTMGridRandomRecipe(num_rand_samples=2, epochs=5): batch 32 | 64 x 2
# draws of units (16|32, 8|16), dropout U(0.1, 0.3), log-uniform lr) and a
# TCN search (TCNGridRandomRecipe(num_rand_samples=2,
# training_iteration=5): channels (16, 16, 16), kernel 3 | 5), 8 trials,
# on TPUSearchEngine(seed=42) with the default scheduler. One warm-up
# round, then AUTOTS["rounds"] timed rounds (the bench's 3).
AUTOTS = dict(points=2000, horizon=1, n_rand=2, epochs=5, rounds=3,
              engine_seed=42)
AUTOTS_PROFILE_STEPS = 10
# Card vs CPU forecaster steps (2 Adam steps at batch 64 on the AutoTS
# windows, f32 with TF32 off for matmuls and cuDNN): each step's loss
# (relative) at BERT's 1e-5, and each gradient at 1e-3 relative to its
# largest entry (BERT's TOL_STEP_GRAD: a gradient is a difference of
# nearly equal sums, here over 64 rows and, for the LSTMs, 50 steps of
# backpropagation through time, summed by cuDNN in another order than the
# CPU's loop; MTNetLite's attention bias, whose gradient is zero in exact
# arithmetic, is held against 1e-3 of the step's largest gradient). The
# control, the card with the two batches swapped, must miss both.
# Readings on an H100 80GB HBM3 at 700 W: losses at most 4.3e-7;
# gradients LSTM 8.1e-6, TCN 1.3e-6, Seq2Seq 1.2e-5, MTNet 4.4e-5; the
# control at least 0.028 (loss) and 2.06 (gradients).
TOL_ZOUWU = {"loss": TOL_STEP_LOSS, "grad": TOL_STEP_GRAD}
# tests/test_zouwu_real_data.py's MTNetLite gate, held for each of five
# initial draws (the nets' init seeds), since one draw's MSE spreads by a
# quarter with the initial weights. On the CPU the port's seed 0 reads
# MTNetLite 0.0318 against the LSTM's 0.0228, over the band 1.3 x 0.0228
# + 1e-3 = 0.0306, and seeds 1-4 read 0.0247-0.0279 against 0.0217-0.0276,
# inside it; the JAX package's seeds 0-4 read 0.0240-0.0265 against
# 0.0211-0.0234 (scripts/nyc_taxi_gate_reference.py). On the card (other
# dropout draws) every seed passed: MTNetLite 0.0251-0.0294 against the
# LSTM's 0.0219-0.0273 (H100 80GB HBM3, 700 W).
REAL_DATA_SEEDS = (0, 1, 2, 3, 4)
# AutoTS under the ASHA TrialRuntime (scheduler="asha", eta 3, grace 1):
# each recipe of autots_trials at 5 random draws (x the batch-size grid of
# 2: 10 trials a recipe) and a 9-epoch budget, so the rungs are [1, 3, 9];
# the same recipe and seed under the default scheduler is the exhaustive
# search (90 epochs a recipe). The ASHA winner's MSE must be within
# ASHA_WINNER_FACTOR of the exhaustive best: the JAX suite's tolerance
# (tests/test_trial_scheduler.py, test_auto_estimator_asha_end_to_end).
ASHA_AUTOTS = dict(n_rand=5, epochs=9, eta=3, grace_period=1)
ASHA_WINNER_FACTOR = 1.5
# Pause/resume and SIGTERM resume through AutoEstimator's TrialModel on the
# card: a 16 -> 64 -> 1 MLP with a 0.1 dropout drawn from the engine's
# step-seeded generator, Adam, 4,096 rows of a noisy linear target, batch
# 128; straight to 4 epochs against 2, a checkpoint written and read back
# through the checkpoint plane, and 2 more. The SIGTERM study: lr
# log-uniform x batch size (64 | 128), 6 draws (12 trials), 9 epochs,
# eta 3, on one lease; every comparison is bit for bit.
ASHA_RESUME = dict(rows=4096, features=16, hidden=64, batch=128, epochs=4,
                   pause_at=2, n_sampling=6, max_t=9, eta=3)
# AutoXGBoost through the engine on the card's lease: the JAX suite's
# targets (tests/test_batch3_components.py) at 10,000 rows, 8 features, a
# 20 % validation split; trees train on the host (numpy), so a device="cpu"
# run must give the same best config and predictions bit for bit.
AUTO_XGB = dict(rows=10000, features=8, n_estimators=50)
# SSD object detection served through ObjectDetector.as_inference_model ->
# ClusterServing, BASELINE #5 (examples/serving/object_detection_serving.py,
# bench.py's bench_serving_od): SSD300 as ssd.py's ssd_300 defines it (300
# px, widths 64 -> 512, the 20 PASCAL classes and background, 8,732
# priors), the trunk in bf16 on the card, decode and NMS in f32, batch 64
# under a 5 ms batch timeout, 100 detections an image; seeded random
# weights and images (neither VOC data nor trained weights are in the
# repository). Then bench_serving_od's own shape: ssd_tiny at 128 px, 3
# classes, batch 64, 512 requests, 20 detections.
OD = dict(size=300, batch=64, max_det=100, requests=512,
          redis_requests=256, timeout_ms=5)
OD_TINY = dict(size=128, classes=("a", "b", "c"), batch=64, requests=512,
               max_det=20)
OD_PROFILE_BATCHES = 4
OD_CPU_BATCH = 8
# Card vs CPU SSD300 (eval mode, 8 images): loc/conf relative to the
# largest. f32 with TF32 off on both: the same convs summed in another
# order; the control, the card's bf16 trunk against the CPU's f32, must
# miss. The postprocessor on the same (the CPU's) loc/conf on both sides:
# labels and order identical, scores and normalized boxes within
# TOL_OD_POST (exp and softmax a few f32 ulps apart). The bf16 trunk
# against the card's f32 (through the servable's cast): bf16 rounding
# through 9 levels; its control, the bf16 trunk on the batch in reverse
# order, must miss. quantize()'s int8 weights against f32: loc/conf within
# TOL_OD_INT8, the control (the int8 values left un-dequantized) must miss;
# the card's dequantized weights against a plain per-output-channel
# quantization on the CPU within TOL_OD_INT8_DEQUANT of the largest weight
# (f32 ulps), the control (scales over the input channels) must miss.
TOL_OD_F32 = 1e-4
TOL_OD_POST = 1e-5
TOL_OD_BF16 = 5e-2
TOL_OD_INT8 = 0.1
TOL_OD_INT8_DEQUANT = 1e-6
# Served SSD answers against the served model's predict on the same images
# in chunks of the batch (_od_hold): a served batch padded to another
# bucket may run other conv algorithms, so its bf16 activations round
# apart; scores (softmax, ~0.05 on random weights) and normalized boxes.
TOL_OD_SERVED_SCORE = 2e-3
TOL_OD_SERVED_BOX = 1e-2
# Hot reload: ssd_tiny at 64 px on 32 toy squares, 6 epochs at batch 8; the
# served answers against the trained model's predict_image_set, pixels
# (batches of other sizes pick other conv algorithms: f32 ulps).
OD_RELOAD = dict(images=32, batch=8, epochs=6)
TOL_OD_RELOAD = 1e-2


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: {msg}")


def device_phase():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return card


def _sass_mma_count(path):
    """Tensor-core instructions (HMMA) in a built library's SASS."""
    out = subprocess.run([_cuda_tool("cuobjdump"), "-sass", path],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    return sum(1 for line in out.splitlines() if "HMMA" in line)


def _cuda_tool(name):
    from shutil import which
    found = which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(found):
        fail(f"{name} not found")
    return found


def build_phase():
    """Builds every kernel library; reports ptxas's registers and spills
    per kernel instance, the HMMA count of each library's SASS, and the
    shared memory and CTAs per SM of each kernel. Fails if a kernel has no
    tensor-core instruction or spills at D = 64."""
    from analytics_zoo_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    libs = _kernels.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: _kernels.ptxas_report(name) for name in libs}
    hmma = {name: _sass_mma_count(path) for name, path in libs.items()}
    occupancy = {
        name: {f"{dt}_d{d}": _kernels.occupancy(name, code, d)
               for dt, code in (("f32", 0), ("bf16", 1)) for d in (64, 128)}
        for name in libs}
    emit({"phase": "build", "seconds": round(seconds, 3),
          "libraries": {k: os.path.relpath(v) for k, v in libs.items()},
          "ptxas": ptxas, "sass_hmma": hmma, "occupancy": occupancy})
    for name in libs:
        if hmma[name] == 0:
            fail(f"{name}: no tensor-core (HMMA) instruction in its SASS")
        for inst in ptxas[name]:
            if inst["head_dim"] == 64 and (inst["spill_store_bytes"]
                                           or inst["spill_load_bytes"]):
                fail(f"{name} spills at D = 64: {inst}")


def _qkv_views(b, s_q, s_k, h, d, dtype, gen):
    """q, k, v as the main path gives them: (B, S, H, D) strided views of
    one fused projection output (q from its own tensor when s_q != s_k)."""
    qkv = torch.randn(b, s_k, 3 * h * d, device="cuda", generator=gen)
    qkv = qkv.to(dtype)
    k = qkv[..., h * d:2 * h * d].view(b, s_k, h, d)
    v = qkv[..., 2 * h * d:].view(b, s_k, h, d)
    if s_q == s_k:
        q = qkv[..., :h * d].view(b, s_q, h, d)
    else:
        q = torch.randn(b, s_q, h, d, device="cuda", generator=gen).to(dtype)
    return q, k, v


def kernel_phase():
    from analytics_zoo_tpu_torch.ops.attention import (flash_attention_plain,
                                                       flash_fwd)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("f32", torch.float32, 128, 128, False),
             ("f32_causal", torch.float32, 128, 128, True),
             ("bf16", torch.bfloat16, 128, 128, False),
             ("bf16_causal", torch.bfloat16, 128, 128, True),
             ("f32_causal_decode", torch.float32, 128, 512, True),
             ("bf16_causal_decode", torch.bfloat16, 128, 512, True),
             ("f32_s2048", torch.float32, 2048, 2048, False),
             ("f32_causal_s2048", torch.float32, 2048, 2048, True)]
    errs = {}
    for name, dtype, s_q, s_k, causal in cases:
        q, k, v = _qkv_views(BATCH, s_q, s_k, 12, 64, dtype, gen)
        out, lse = flash_fwd(q, k, v, causal=causal, with_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        ok = (err <= tol and lse_err <= TOL_LSE
              and bool(torch.isfinite(out).all()))
        emit({"phase": "kernel_vs_plain", "kernel": "flash_fwd",
              "case": name, "shape": [BATCH, s_q, s_k, 12, 64],
              "max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err,
              "lse_tol": TOL_LSE, "ok": ok})
        if not ok:
            fail(f"flash_fwd disagrees with its plain version ({name})")
        errs[name] = err
    return errs


def _rel_err(a, b):
    b = b.float()
    return ((a.float() - b).abs().max() / b.abs().max().clamp_min(1e-30)
            ).item()


def bwd_kernel_phase():
    """B2 and B3 against their plain version on the card (and B2's delta
    against rowsum(g * o)), and in f32 against autograd through the
    materialised-scores reference. Every case runs before a failure is
    raised, so one line per case is printed."""
    from analytics_zoo_tpu_torch.ops import attention as at
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [("f32", torch.float32, 128, 128, False),
             ("f32_causal", torch.float32, 128, 128, True),
             ("f32_causal_decode", torch.float32, 128, 512, True),
             ("bf16", torch.bfloat16, 128, 128, False),
             ("bf16_causal", torch.bfloat16, 128, 128, True),
             ("bf16_causal_decode", torch.bfloat16, 128, 512, True),
             ("f32_s2048", torch.float32, 2048, 2048, False),
             ("f32_causal_s2048", torch.float32, 2048, 2048, True)]
    errs, failed = {}, []
    for name, dtype, s_q, s_k, causal in cases:
        q, k, v = _qkv_views(BATCH, s_q, s_k, 12, 64, dtype, gen)
        g = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        o, lse2 = at.flash_fwd(q, k, v, causal=causal, with_lse=True)
        n0 = (at.flash_bwd_dq.launches, at.flash_bwd_dkv.launches)
        dq, delta = at.flash_bwd_dq(q, k, v, o, lse2, g, causal=causal)
        dk, dv = at.flash_bwd_dkv(q, k, v, g, lse2, delta, causal=causal)
        torch.cuda.synchronize()
        launched = (at.flash_bwd_dq.launches - n0[0],
                    at.flash_bwd_dkv.launches - n0[1])
        ref = at.flash_bwd_plain(q, k, v, o, lse2, g, causal=causal)
        rel = {n: _rel_err(a, b) for n, a, b in
               zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
        absd = {n: (a.float() - b.float()).abs().max().item() for n, a, b in
                zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
        delta_err = _rel_err(delta, at._bwd_delta(g, o))
        finite = all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
        ok = (launched == (1, 1) and finite
              and max(rel.values()) <= TOL_BWD[dtype]
              and delta_err <= TOL_BWD[torch.float32])
        emit({"phase": "kernel_vs_plain", "kernel": "flash_bwd_dq+dkv",
              "case": name, "shape": [BATCH, s_q, s_k, 12, 64],
              "rel_err": rel, "max_abs_err": absd, "tol_rel": TOL_BWD[dtype],
              "delta_rel_err": delta_err, "launches": launched, "ok": ok})
        if not ok:
            failed.append(name)
        errs[name] = absd
    # f32, against autograd through the reference attention
    q, k, v = _qkv_views(8, 128, 128, 12, 64, torch.float32, gen)
    g = torch.randn(q.shape, device="cuda", generator=gen)
    grads = []
    for fn in (at.flash_attention, at.mha_reference):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves).backward(g)
        grads.append([t.grad for t in leaves])
    rel = {n: _rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), *grads)}
    ok = max(rel.values()) <= TOL_BWD[torch.float32]
    emit({"phase": "kernel_vs_plain", "kernel": "flash_bwd_dq+dkv",
          "case": "f32_vs_autograd_mha_reference",
          "shape": [8, 128, 128, 12, 64], "rel_err": rel,
          "tol_rel": TOL_BWD[torch.float32], "ok": ok})
    if not ok:
        failed.append("f32_vs_autograd_mha_reference")
    if failed:
        fail(f"flash_bwd kernels disagree with their reference in {failed}")
    return errs


def _bert_state(module, seed):
    """Seeded random weights from numpy for every entry of the state
    dict: N(0, 0.02) for matrices, tables and biases, 1 + N(0, 0.02) for
    LayerNorm scales."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, t in module.state_dict().items():
        w = rng.standard_normal(tuple(t.shape), dtype=np.float32) * 0.02
        if "norm" in key and key.endswith("weight"):
            w += 1.0
        state[key] = torch.from_numpy(w)
    return state


def serve_phase(card):
    from analytics_zoo_tpu_torch.ops.attention import flash_fwd
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                                 InMemoryBroker, InputQueue,
                                                 OutputQueue)
    from analytics_zoo_tpu_torch.tfpark.text.estimator import (BERT_BASE,
                                                               _BertWithHead)

    t0 = time.perf_counter()
    cfg = tuple(sorted(BERT_BASE.items()))
    torch.manual_seed(0)
    card_module = _BertWithHead(cfg, num_out=2)
    state = _bert_state(card_module, seed=0)
    model = InferenceModel(device="cuda").load_module(card_module, state)
    n_layers = BERT_BASE["n_block"]
    ids = np.random.default_rng(1).integers(
        0, BERT_BASE["vocab"], (N_REQUESTS, SEQ)).astype(np.int32)

    broker = InMemoryBroker()
    serving = ClusterServing(model, queue=broker, batch_size=BATCH)
    t_pre = time.perf_counter()
    serving.start(example=ids[:1])     # precompile: warms every bucket
    precompile_s = time.perf_counter() - t_pre
    inq, outq = InputQueue(broker), OutputQueue(broker)
    try:
        entry = serving.mux.default
        batches0 = entry.batches
        flash_fwd.launches = 0          # the main path starts here
        t_enq = {}
        t_start = time.time()
        for i in range(N_REQUESTS):
            uri = f"req-{i}"
            t_enq[uri] = time.time()
            inq.enqueue(uri, t=ids[i])
        # answers are fetched in enqueue order; a request's latency runs
        # from its enqueue to the moment the client holds its answer
        answers, t_done = {}, {}
        for uri in t_enq:
            data = outq.query(uri, timeout_s=120.0)
            if not isinstance(data, np.ndarray):
                fail(f"no answer for {uri}: {data!r}")
            answers[uri], t_done[uri] = data, time.time()
    finally:
        serving.stop()      # joins the workers: their counters are final
    torch.cuda.synchronize()
    launches = flash_fwd.launches       # the main path ends here
    batches = entry.batches - batches0
    stages = serving.metrics()["stages"]
    served = np.stack([answers[f"req-{i}"] for i in range(N_REQUESTS)])
    if served.shape != (N_REQUESTS, 2) or not np.isfinite(served).all():
        fail(f"served logits malformed: shape {served.shape}")
    if launches != n_layers * batches:
        fail(f"flash_fwd launched {launches} times for {batches} batches "
             f"of a {n_layers}-layer model")
    lat = sorted((t_done[u] - t_enq[u]) * 1e3 for u in t_enq)
    wall = max(t_done.values()) - t_start

    cpu_module = _BertWithHead(cfg, num_out=2)
    cpu_model = InferenceModel(device="cpu").load_module(cpu_module, state)
    cpu_logits = cpu_model.predict(ids[:N_CPU_CHECK])
    err = float(np.abs(served[:N_CPU_CHECK] - cpu_logits).max())
    if not err <= TOL_SERVED:
        fail(f"served logits differ from the CPU forward by {err}")
    emit({"phase": "serve", "model": "BERT-Base (uncased widths), 2 classes",
          "requests": N_REQUESTS, "answered": len(answers),
          "seq_len": SEQ, "batch_size": BATCH, "batches": batches,
          "flash_fwd_launches": launches, "layers": n_layers,
          "precompile_s": precompile_s,
          "records_per_s": N_REQUESTS / wall,
          "latency_ms_p50": float(np.percentile(lat, 50)),
          "latency_ms_p99": float(np.percentile(lat, 99)),
          "served_vs_cpu_max_abs_err": err, "tol": TOL_SERVED,
          "logit_abs_max": float(np.abs(served).max()),
          "stages_ms": {k: {m: v[m] for m in ("count", "mean_ms", "p50_ms")}
                        for k, v in stages.items()},
          "card": card, "setup_s": t_pre - t0})
    return launches, model, ids


def profile_phase(model, ids, card):
    """Where one full served batch spends device time: torch.profiler
    over one ``predict`` of BATCH x SEQ, kernel time summed by class."""
    from torch.profiler import ProfilerActivity, profile
    batch = ids[:BATCH]
    model.predict(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.predict(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class = {"flash_fwd": 0.0, "gemm": 0.0, "other": 0.0}
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += 1
        name = evt.name.lower()
        cls = ("flash_fwd" if "flash_fwd" in name else
               "gemm" if ("gemm" in name or "xmma" in name
                          or "cutlass" in name) else "other")
        by_class[cls] += evt.time_range.elapsed_us() / 1e3
    device_ms = sum(by_class.values())
    emit({"phase": "profile", "batch": [BATCH, SEQ], "wall_ms": wall_ms,
          "device_ms": device_ms, "device_ms_by_class": by_class,
          "kernels": n_kernels,
          "device_idle_share": (1.0 - device_ms / wall_ms) if device_ms
          else None, "card": card})


def train_phase(card):
    """BERT-Base fine-tuning through BERTClassifier.fit on the card: 256
    rows of 128 ids with no input mask (every layer takes the flash
    kernels), batch 32, 2 epochs, AdamWeightDecay(lr=2e-5), the config's
    dropout kept."""
    from analytics_zoo_tpu_torch.ops import attention as at
    from analytics_zoo_tpu_torch.orca.learn.optimizers import \
        AdamWeightDecay
    from analytics_zoo_tpu_torch.tfpark.text.estimator import (
        BERT_BASE, BERTClassifier)

    t0 = time.perf_counter()
    torch.manual_seed(0)
    est = BERTClassifier(num_classes=2, bert_config=BERT_BASE,
                         optimizer=AdamWeightDecay(lr=2e-5))
    est.module.load_state_dict(_bert_state(est.module, seed=0))
    rng = np.random.default_rng(4)
    ids = rng.integers(0, BERT_BASE["vocab"], (TRAIN_ROWS, SEQ)).astype(
        np.int32)
    data = {"x": ids, "y": (ids[:, 1] % 2).astype(np.int32)}
    steps = TRAIN_EPOCHS * TRAIN_ROWS // BATCH
    n_layers = BERT_BASE["n_block"]

    kernels = (at.flash_fwd, at.flash_bwd_dq, at.flash_bwd_dkv)
    setup_s = time.perf_counter() - t0
    for fn in kernels:
        fn.launches = 0                 # the main path starts here
    t_fit = time.perf_counter()
    # profile=True: each step's span on the device timeline (CUDA events)
    stats = est.fit(data, epochs=TRAIN_EPOCHS, batch_size=BATCH,
                    verbose=False, profile=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    launches = {fn.__name__: fn.launches for fn in kernels}  # ends here
    step_ms = [t for s in stats for t in s["profile"]["step_ms"]]

    losses = [s["train_loss"] for s in stats]
    if len(stats) != TRAIN_EPOCHS or not all(map(math.isfinite, losses)):
        fail(f"training losses not finite: {losses}")
    if len(step_ms) != steps:
        fail(f"fit took {len(step_ms)} steps, expected {steps}")
    for name, n in launches.items():
        if n != n_layers * steps:
            fail(f"{name} launched {n} times in {steps} steps of a "
                 f"{n_layers}-layer model (expected {n_layers * steps})")
    ev = est.evaluate(data, batch_size=BATCH, verbose=False)
    pred = est.predict(ids[:64], batch_size=BATCH)
    if (pred.shape != (64, 2) or not np.isfinite(pred).all()
            or not math.isfinite(ev["loss"])
            or not 0.0 <= ev["sparse_categorical_accuracy"] <= 1.0):
        fail(f"evaluate/predict after fit malformed: {ev}, {pred.shape}")
    median_ms = statistics.median(step_ms[1:])
    emit({"phase": "train", "model": "BERT-Base (uncased widths), 2 classes",
          "entry": "BERTClassifier.fit", "rows": TRAIN_ROWS, "seq_len": SEQ,
          "batch_size": BATCH, "epochs": TRAIN_EPOCHS, "steps": steps,
          "optimizer": "AdamWeightDecay(lr=2e-5)", "train_loss": losses,
          "launches": launches, "fit_s": fit_s,
          "samples_per_s": TRAIN_EPOCHS * TRAIN_ROWS / fit_s,
          "step_ms": step_ms, "step_ms_median_after_first": median_ms,
          "step_ms_min_after_first": min(step_ms[1:]),
          "step_ms_max_after_first": max(step_ms[1:]),
          "steady_samples_per_s": BATCH / (median_ms / 1e3),
          "evaluate": ev, "predict_shape": list(pred.shape),
          "card": card, "setup_s": setup_s})
    return launches, est, data


def profile_train_phase(est, data, card):
    """Where one training step of BATCH x SEQ spends device time:
    torch.profiler over one step, kernel time summed by class."""
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.orca.learn.utils import Batch
    batch = Batch(x=(data["x"][:BATCH],), y=(data["y"][:BATCH],), w=None)
    est.engine.train_batch(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.engine.train_batch(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class = {"gemm": 0.0, "flash_fwd": 0.0, "flash_bwd_dq": 0.0,
                "flash_bwd_dkv": 0.0, "other": 0.0}
    counts = dict.fromkeys(by_class, 0)
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.name.lower()
        cls = next((c for c in ("flash_bwd_dq", "flash_bwd_dkv", "flash_fwd")
                    if c in name), None)
        if cls is None:
            cls = ("gemm" if ("gemm" in name or "xmma" in name
                              or "cutlass" in name) else "other")
        by_class[cls] += evt.time_range.elapsed_us() / 1e3
        counts[cls] += 1
    device_ms = sum(by_class.values())
    emit({"phase": "profile_train", "batch": [BATCH, SEQ],
          "wall_ms": wall_ms, "device_ms": device_ms,
          "device_ms_by_class": by_class, "kernels_by_class": counts,
          "kernels": sum(counts.values()),
          "device_idle_share": (1.0 - device_ms / wall_ms) if device_ms
          else None, "card": card})


def train_vs_cpu_phase(card):
    """Two training steps of the port's engine from the same weights, on
    the card and on the CPU: every dropout at 0, batch 4 x SEQ, TF32 off on
    both (the package switches it off)."""
    from analytics_zoo_tpu_torch.orca.learn.estimator import TPUEstimator
    from analytics_zoo_tpu_torch.orca.learn.losses import \
        sparse_categorical_crossentropy
    from analytics_zoo_tpu_torch.orca.learn.optimizers import \
        AdamWeightDecay
    from analytics_zoo_tpu_torch.orca.learn.utils import Batch
    from analytics_zoo_tpu_torch.tfpark.text.estimator import (
        BERT_BASE, _BertWithHead)

    cfg = tuple(sorted(dict(BERT_BASE, hidden_p_drop=0.0,
                            attn_p_drop=0.0).items()))
    torch.manual_seed(0)
    state = None
    rng = np.random.default_rng(6)
    ids = rng.integers(0, BERT_BASE["vocab"], (8, SEQ)).astype(np.int32)
    labels = (ids[:, 1] % 2).astype(np.int32)
    runs = {}
    for dev in ("cuda", "cpu"):
        module = _BertWithHead(cfg, num_out=2, head_drop=0.0)
        state = state or _bert_state(module, seed=5)
        module.load_state_dict(state)
        est = TPUEstimator(module, loss=partial(
            sparse_categorical_crossentropy, from_logits=True),
            optimizer=AdamWeightDecay(lr=2e-5), device=dev)
        est.engine.build()
        losses, grads = [], None
        for step in range(2):
            rows = slice(4 * step, 4 * step + 4)
            losses.append(float(est.engine.train_batch(
                Batch(x=(ids[rows],), y=(labels[rows],), w=None))))
            if step == 0:
                grads = {n: p.grad.detach().cpu().clone()
                         for n, p in module.named_parameters()}
        runs[dev] = (losses, grads)
    (l_gpu, g_gpu), (l_cpu, g_cpu) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    grad_err = {n: _rel_err(g_gpu[n], g_cpu[n]) for n in g_cpu}
    worst = max(grad_err, key=grad_err.get)
    ok = (loss_err <= TOL_STEP_LOSS and grad_err[worst] <= TOL_STEP_GRAD
          and all(map(math.isfinite, l_gpu)))
    emit({"phase": "train_vs_cpu", "batch": [4, SEQ], "steps": 2,
          "loss_card": l_gpu, "loss_cpu": l_cpu, "loss_rel_err": loss_err,
          "loss_tol": TOL_STEP_LOSS, "grad_rel_err_max": grad_err[worst],
          "grad_rel_err_worst_param": worst, "grad_tol": TOL_STEP_GRAD,
          "params_compared": len(grad_err), "card": card, "ok": ok})
    if not ok:
        fail("training on the card disagrees with the CPU")


# --- NCF -------------------------------------------------------------------

def _ncf_data(rows, seed=0):
    """bench_ncf's data: random (user, item) pairs over MovieLens-1M's
    counts and 5 rating classes."""
    rng = np.random.RandomState(seed)
    pairs = np.stack([rng.randint(1, NCF_WIDTHS["user_count"], rows),
                      rng.randint(1, NCF_WIDTHS["item_count"], rows)],
                     -1).astype(np.int32)
    return pairs, rng.randint(0, 5, rows).astype(np.int32)


def _ncf_model(dtype=torch.bfloat16, seed=0, device=None, model_dir=None):
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.orca.learn.optimizers import Adam
    model = NeuralCF(compute_dtype=dtype, seed=seed, device=device,
                     **NCF_WIDTHS)
    model.compile(loss="sparse_categorical_crossentropy",
                  optimizer=Adam(lr=1e-3), model_dir=model_dir)
    return model


class _Count:
    """Counts the calls of a module function (the embedding backward's
    row sum and the one-hot matmul), to show which one the path took;
    with ``keep``, also keeps each call's arguments, on the CPU."""

    def __init__(self, module, name, keep=False):
        self.module, self.name = module, name
        self.inner = getattr(module, name)
        self.calls, self.keep, self.args = 0, keep, []
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.keep:
            self.args.append(tuple(a.detach().cpu().clone()
                                   if isinstance(a, torch.Tensor) else a
                                   for a in args))
        return self.inner(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.inner)


def ncf_train_phase(card):
    """NCF flagship training through NeuralCF.fit: 2 epochs of 8 steps at
    batch 262,144, Adam(lr=1e-3), bf16 compute, the checkpoint plane with
    an every-epoch trigger, the prefetching infeed; then a fresh model on
    the card restores the checkpoint and evaluates to the same loss."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.ops import embedding as emb
    from analytics_zoo_tpu_torch.orca.learn.trigger import EveryEpoch

    t0 = time.perf_counter()
    pairs, ratings = _ncf_data(NCF_ROWS)
    data = {"x": pairs, "y": ratings}
    model_dir = tempfile.mkdtemp(prefix="ncf-ckpt-")
    try:
        model = _ncf_model(model_dir=model_dir)
        setup_s = time.perf_counter() - t0
        steps = NCF_EPOCHS * NCF_ROWS // NCF_BATCH
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        row_sum = _Count(emb, "onehot_sum_backward")   # the path starts
        matmul = _Count(emb, "onehot_matmul_backward")
        t_fit = time.perf_counter()
        stats = model.fit(data, epochs=NCF_EPOCHS, batch_size=NCF_BATCH,
                          verbose=False, profile=True,
                          checkpoint_trigger=EveryEpoch())
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t_fit
        row_sum.restore()
        matmul.restore()                                # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        pipe = model.estimator.data_pipeline_stats()
        step_ms = [t for s in stats for t in s["profile"]["step_ms"]]
        losses = [s["train_loss"] for s in stats]
        if len(step_ms) != steps or not all(map(math.isfinite, losses)):
            fail(f"NCF fit: {len(step_ms)} steps (expected {steps}), "
                 f"losses {losses}")
        if row_sum.calls != 2 * steps or matmul.calls:
            fail(f"NCF backward took the row sum {row_sum.calls} times and "
                 f"the one-hot matmul {matmul.calls} times in {steps} "
                 f"steps (expected {2 * steps} and 0)")
        if pipe["ckpt"]["saves"] < NCF_EPOCHS or pipe["ckpt"]["errors"]:
            fail(f"NCF checkpoints: {pipe['ckpt']}")
        ev_rows = {"x": pairs[:NCF_BATCH], "y": ratings[:NCF_BATCH]}
        ev = model.evaluate(ev_rows, batch_size=NCF_BATCH, verbose=False)
        fresh = _ncf_model(seed=1)
        restored = fresh.estimator.load_checkpoint(model_dir)
        ev2 = fresh.evaluate(ev_rows, batch_size=NCF_BATCH, verbose=False)
        if not math.isfinite(ev["loss"]) or ev2["loss"] != ev["loss"]:
            fail(f"NCF restored loss {ev2['loss']} != trained {ev['loss']}")
        probs = model.predict(pairs[:4096], batch_size=NCF_BATCH)
        if probs.shape != (4096, 5) or not np.allclose(probs.sum(-1), 1.0,
                                                      atol=1e-3):
            fail(f"NCF predict malformed: {probs.shape}")
        median_ms = statistics.median(step_ms[1:])
        emit({"phase": "ncf_train",
              "model": "NCF flagship, MovieLens-1M widths",
              "entry": "NeuralCF.fit", "widths": NCF_WIDTHS,
              "compute_dtype": "bfloat16", "rows": NCF_ROWS,
              "batch_size": NCF_BATCH, "epochs": NCF_EPOCHS, "steps": steps,
              "optimizer": "Adam(lr=1e-3)", "train_loss": losses,
              "step_ms": step_ms, "step_ms_median_after_first": median_ms,
              "steady_samples_per_s": NCF_BATCH / (median_ms / 1e3),
              "fit_s": fit_s,
              "fit_samples_per_s": NCF_EPOCHS * NCF_ROWS / fit_s,
              "embed_bwd_row_sum_calls": row_sum.calls,
              "embed_bwd_matmul_calls": matmul.calls,
              "data_pipeline_stats": pipe,
              "max_memory_allocated_bytes": peak,
              "evaluate_loss": ev["loss"], "restored_loss": ev2["loss"],
              "restored_from": os.path.basename(restored),
              "card": card, "setup_s": setup_s})
        return model, pairs, ratings
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)


def _device_events(prof):
    """The profiler's device events: kernels and copies. A
    ``record_function`` range (the optimizer's ``Optimizer.step#...``, the
    fraud phase's ``loss``) also appears on the device timeline as a user
    annotation spanning the kernels inside it; it is not device work."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _busy_ms(events):
    """The union of the device events' intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def ncf_profile_phase(model, pairs, ratings, card):
    """Where NCF training steps spend device time, with the infeed's
    prefetch on and off: torch.profiler over NCF_PROFILE_STEPS steps (each
    takes its batch from the epoch iterator, as fit does) after a warm
    step, kernel time summed by class, and the share of the window the
    device sat idle (no kernel or copy running)."""
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.native.infeed import PipelineStats
    from analytics_zoo_tpu_torch.orca.learn.utils import (
        BatchIterator, xshards_from_arrays)
    eng = model.estimator.engine
    out = {}
    for prefetch in (True, False):
        it = BatchIterator(xshards_from_arrays({"x": pairs, "y": ratings}),
                           NCF_BATCH, shuffle=True, device=eng.device,
                           stats=PipelineStats())
        batches = it.epoch(prefetch=prefetch)
        eng.train_batch(next(batches))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(NCF_PROFILE_STEPS):
                eng.train_batch(next(batches))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        batches.close()
        by_class = {"embedding_index": 0.0, "gemm": 0.0, "adam": 0.0,
                    "h2d_copy": 0.0, "other": 0.0}
        dev_events = _device_events(prof)
        for evt in dev_events:
            name = evt.name.lower()
            if "memcpy" in name or "htod" in name:
                cls = "h2d_copy"
            elif "gemm" in name or "xmma" in name or "cutlass" in name:
                cls = "gemm"
            elif "multi_tensor_apply" in name or "adam" in name:
                cls = "adam"
            elif "index" in name or "gather" in name or "scatter" in name:
                cls = "embedding_index"
            else:
                cls = "other"
            by_class[cls] += evt.time_range.elapsed_us() / 1e3
        busy = _busy_ms(dev_events)
        if not dev_events:
            fail("the profiler saw no device time in the NCF steps")
        out["prefetch_on" if prefetch else "prefetch_off"] = {
            "wall_ms_per_step": wall_ms / NCF_PROFILE_STEPS,
            "device_busy_ms_per_step": busy / NCF_PROFILE_STEPS,
            "device_ms_by_class_per_step": {
                k: v / NCF_PROFILE_STEPS for k, v in by_class.items()},
            "device_idle_share": 1.0 - busy / wall_ms,
            "device_events": len(dev_events),
            "pipeline": it.stats.snapshot()}
    out["pump_vs_inline"] = _pump_vs_inline(pairs, ratings, eng.device)
    emit({"phase": "ncf_profile", "batch": NCF_BATCH,
          "steps_profiled": NCF_PROFILE_STEPS,
          "classes": {"embedding_index": "gather and index_add kernels of "
                      "the two lookups (their elementwise masks are in "
                      "other)", "gemm": "the MLP and head matmuls",
                      "adam": "torch.optim.Adam's multi-tensor kernels",
                      "h2d_copy": "host-to-device batch copies"},
          **out, "card": card})


def _pump_vs_inline(pairs, ratings, device):
    """The prefetching infeed delivers, on the card, the batches the
    inline path copies, over enough epochs that every pinned staging slot
    is refilled at least once (batch k takes slot k mod ring, so more than
    2 x ring batches; the ring must not refill a slot while its last copy
    is in flight)."""
    from analytics_zoo_tpu_torch.orca.learn.utils import (
        BatchIterator, xshards_from_arrays)
    its = [BatchIterator(xshards_from_arrays({"x": pairs, "y": ratings}),
                         NCF_BATCH, shuffle=True, device=device)
           for _ in range(2)]
    checked = epochs = 0
    while epochs == 0 or checked <= 2 * its[0]._staging.ring:
        for got, want in zip(its[0].epoch(prefetch=True),
                             its[1].epoch(prefetch=False)):
            got, want = got.to(device), want.to(device)
            for a, b in zip(got.leaves(), want.leaves()):
                if not torch.equal(a, b):
                    fail(f"the infeed delivered batch {checked} torn")
            checked += 1
        epochs += 1
    return {"batches": checked, "epochs": epochs,
            "ring_slots": its[0]._staging.ring, "equal": True}


def _ncf_two_steps(dtype, dev, pairs, ratings):
    """Two NCF training steps from the seeded weights on ``dev``: the
    losses, the first step's gradients and the first step's embedding
    cotangents by table (ids and cotangents as the backward got them), all
    on the CPU."""
    from analytics_zoo_tpu_torch.ops import embedding as emb
    from analytics_zoo_tpu_torch.orca.learn.utils import Batch
    model = _ncf_model(dtype=dtype, seed=3, device=dev)
    eng = model.estimator.engine
    eng.build()
    losses, grads = [], None
    for step in range(2):
        rows = slice(step * NCF_CPU_BATCH, (step + 1) * NCF_CPU_BATCH)
        rec = _Count(emb, "onehot_sum_backward", keep=step == 0)
        try:
            losses.append(float(eng.train_batch(Batch(
                x=(pairs[rows],), y=(ratings[rows],), w=None))))
        finally:
            rec.restore()
        if step == 0:
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in model.module.named_parameters()}
            cot = {("user_embed_table" if n_rows == NCF_WIDTHS["user_count"]
                    + 1 else "item_embed_table"): (ids, g)
                   for ids, g, n_rows, _ in rec.args}
    return losses, grads, cot


def _bf16_flips(a, b):
    """How many elements round to different bf16 values."""
    return int((a.to(torch.bfloat16) != b.to(torch.bfloat16)).sum())


def _rows_off(a, b, frac=1e-2):
    """How many rows differ somewhere by more than ``frac`` of ``b``'s
    largest element."""
    limit = frac * b.abs().max()
    return int(((a - b).abs().amax(-1) > limit).sum())


def ncf_vs_cpu_phase(card):
    """Two NCF training steps from the same seeded weights and batches on
    the card and on the CPU, at the flagship widths and batch
    NCF_CPU_BATCH: once in f32 compute (BERT's tolerances) and once in
    bf16 compute (the flagship), each held as the tolerances above say; the
    bf16 limits are shown to reject f32 compute."""
    from analytics_zoo_tpu_torch.ops import embedding as emb
    pairs, ratings = _ncf_data(2 * NCF_CPU_BATCH, seed=7)
    runs = {(dtype, dev): _ncf_two_steps(dtype, dev, pairs, ratings)
            for dtype in (torch.float32, torch.bfloat16)
            for dev in ("cuda", "cpu")}
    tables = ("user_embed_table", "item_embed_table")

    def readings(card_run, cpu_run):
        (_, g_gpu, c_gpu), (_, g_cpu, c_cpu) = card_run, cpu_run
        out = {n: _rel_err(g_gpu[n], g_cpu[n]) for n in g_cpu
               if n not in tables}
        out.update({f"{t}.cotangent": _rel_err(c_gpu[t][1], c_cpu[t][1])
                    for t in tables})
        return out

    def limit(name, f32):
        if f32:
            return TOL_STEP_GRAD
        return TOL_NCF_BF16_GRAD["cotangent" if name.endswith("cotangent")
                                 else "head" if name.startswith("head")
                                 else "mlp"]

    result, failed = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        (l_gpu, g_gpu, c_gpu) = runs[(dtype, "cuda")]
        (l_cpu, g_cpu, c_cpu) = runs[(dtype, "cpu")]
        tol_loss = TOL_STEP_LOSS if f32 else TOL_NCF_BF16_LOSS
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
        grad_err = readings(runs[(dtype, "cuda")], runs[(dtype, "cpu")])
        grad_tol = {n: limit(n, f32) for n in grad_err}
        table = {}
        for t in tables:
            ids, g = c_gpu[t]
            rows = g_gpu[t].shape[0]
            table[t] = {
                # the card's backward against the plain version on the
                # card's own ids and cotangents: held
                "vs_plain_on_card_cotangents": _rel_err(
                    g_gpu[t], emb.onehot_matmul_backward(ids, g, rows,
                                                         torch.float32)),
                # reported: the card's table gradient against the CPU's,
                # and the CPU's backward on the card's cotangents against
                # the CPU's (the cotangents' share of the difference)
                "card_vs_cpu": _rel_err(g_gpu[t], g_cpu[t]),
                "cpu_bwd_on_card_cotangents_vs_cpu": _rel_err(
                    emb.onehot_matmul_backward(ids, g, rows, torch.float32),
                    g_cpu[t]),
                "cotangent_bf16_flips": _bf16_flips(g, c_cpu[t][1]),
                "cotangent_elements": g.numel(),
                "cotangent_rows_off_by_1pct": _rows_off(g, c_cpu[t][1]),
                "cotangent_rows": g.shape[0]}
        ok = (loss_err <= tol_loss and all(map(math.isfinite, l_gpu))
              and all(grad_err[n] <= grad_tol[n] for n in grad_err)
              and all(v["vs_plain_on_card_cotangents"] <= TOL_EMBED_BWD
                      for v in table.values()))
        entry = {"loss_card": l_gpu, "loss_cpu": l_cpu,
                 "loss_rel_err": loss_err, "loss_tol": tol_loss,
                 "grad_rel_err": grad_err, "grad_tol": grad_tol,
                 "tables": table, "table_tol": TOL_EMBED_BWD, "ok": ok}
        if not f32:
            # the control: f32 compute on the card against bf16 compute on
            # the CPU must miss every bf16 limit
            control = readings(runs[(torch.float32, "cuda")],
                               runs[(torch.bfloat16, "cpu")])
            entry["control_f32_card_vs_bf16_cpu"] = control
            entry["control_rejected"] = all(control[n] > grad_tol[n]
                                            for n in control)
            ok = entry["ok"] = ok and entry["control_rejected"]
        result["float32" if f32 else "bfloat16"] = entry
        if not ok:
            failed.append("f32" if f32 else "bf16")
    emit({"phase": "ncf_vs_cpu", "batch": NCF_CPU_BATCH, "steps": 2,
          **result, "card": card})
    if failed:
        fail(f"NCF training on the card disagrees with the CPU "
             f"({', '.join(failed)} compute)")


def embed_bwd_phase(card):
    """The embedding's one-hot backward as the port computes it (an f32
    row sum of the bf16-rounded cotangents, index_add_) against the one-hot
    matmul it replaces, on the card: equal to TOL_EMBED_BWD of the largest
    gradient at EMBED_BWD_CHECK_IDS ids, then both timed at NCF's batch for
    each of its two tables (CUDA events around CUDA-graph replays)."""
    from analytics_zoo_tpu_torch.ops import embedding as emb
    gen = torch.Generator(device="cuda").manual_seed(9)
    cols = NCF_WIDTHS["user_embed"] + NCF_WIDTHS["mf_embed"]
    tables = {"user": NCF_WIDTHS["user_count"] + 1,
              "item": NCF_WIDTHS["item_count"] + 1}
    out = {}
    for name, rows in tables.items():
        ids = torch.randint(0, rows, (EMBED_BWD_CHECK_IDS,), device="cuda",
                            generator=gen)
        g = torch.randn(EMBED_BWD_CHECK_IDS, cols, device="cuda",
                        generator=gen)
        got = emb.onehot_sum_backward(ids, g, rows, torch.float32)
        want = emb.onehot_matmul_backward(ids, g, rows, torch.float32)
        err = _rel_err(got, want)
        if err > TOL_EMBED_BWD:
            fail(f"embedding backward ({name} table): {err} > "
                 f"{TOL_EMBED_BWD} against the one-hot matmul")
        ids = torch.randint(0, rows, (NCF_BATCH,), device="cuda",
                            generator=gen)
        g = torch.randn(NCF_BATCH, cols, device="cuda", generator=gen)
        times = _time_in_turns({
            "row_sum": lambda: emb.onehot_sum_backward(ids, g, rows,
                                                       torch.float32),
            "matmul": lambda: emb.onehot_matmul_backward(ids, g, rows,
                                                         torch.float32)},
            reps=3, rounds=3, graphs=True)
        nbytes = g.numel() * 4 + ids.numel() * 8 + rows * cols * 4
        out[name] = {"rows": rows, "cols": cols, "max_rel_err": err,
                     "checked_ids": EMBED_BWD_CHECK_IDS,
                     "ms": _spread(times["row_sum"]),
                     "onehot_matmul_ms": _spread(times["matmul"]),
                     "onehot_bytes": NCF_BATCH * rows * 4,
                     "onehot_matmul_flops": 2.0 * NCF_BATCH * rows * cols,
                     "bound_ms": nbytes / PEAK_BYTES * 1e3,
                     "bound_by": "bytes"}
    emit({"phase": "embed_bwd", "ids": NCF_BATCH, "tol": TOL_EMBED_BWD,
          "tables": out, "card": card})


# --- ResNet-50 ---------------------------------------------------------------

def _resnet_schedule(spe):
    """bench_resnet50's lr: warm up over 5 epochs to 0.1 * batch / 256,
    then decay as poly(2) over 85 epochs."""
    from analytics_zoo_tpu_torch.orca.learn.optimizers.schedule import (
        Poly, SequentialSchedule, Warmup)
    peak = 0.1 * RESNET["batch"] / 256
    warm = 5 * spe
    return (SequentialSchedule().add(Warmup(delta=peak / warm), warm)
            .add(Poly(2.0, 85 * spe), 85 * spe))


def _resnet_estimator(seed, dev, sched=None, dtype=torch.bfloat16, lr=0.0,
                      model_dir=None):
    """ResNet-50 from torch's generator seeded with ``seed``, trained by
    SGD with momentum 0.9. The loss takes the logits head's output as
    logits: bench_resnet50's string loss expects probabilities and, fed
    logits, clips the true class's at its epsilon with a zero gradient."""
    from analytics_zoo_tpu_torch.models.image import resnet
    from analytics_zoo_tpu_torch.orca.learn.estimator import TPUEstimator
    from analytics_zoo_tpu_torch.orca.learn.losses import \
        sparse_categorical_crossentropy
    from analytics_zoo_tpu_torch.orca.learn.optimizers import SGD
    torch.manual_seed(seed)
    model = resnet(RESNET["depth"], RESNET["classes"], compute_dtype=dtype)
    return TPUEstimator(
        model, loss=partial(sparse_categorical_crossentropy,
                            from_logits=True),
        optimizer=SGD(learningrate=lr, momentum=0.9,
                      leaningrate_schedule=sched),
        model_dir=model_dir, device=dev)


class _LrLog:
    """Records the lr each optimizer step applies (param group 0)."""

    def __init__(self, opt):
        self.opt, self.inner, self.lrs = opt, opt.step, []
        opt.step = self

    def __call__(self, *args, **kwargs):
        self.lrs.append(self.opt.param_groups[0]["lr"])
        return self.inner(*args, **kwargs)


def resnet_train_phase(card, root):
    """bench_resnet50's configuration through TPUEstimator.fit over the
    streaming ImageNetPipeline: 2 epochs of 8 steps with the checkpoint
    plane (an every-epoch trigger) and the prefetching infeed; each step's
    lr is held to the schedule's; then a fresh model restores the last
    checkpoint and evaluates an eval-mode pipeline to the same loss."""
    from analytics_zoo_tpu_torch.orca.data.image import (
        ImageNetPipeline, write_synthetic_imagenet)
    from analytics_zoo_tpu_torch.orca.learn.trigger import EveryEpoch

    t0 = time.perf_counter()
    data_dir = os.path.join(root, "data")
    model_dir = os.path.join(root, "ckpt")
    write_synthetic_imagenet(data_dir, RESNET["images"],
                             image_size=RESNET["image_size"],
                             num_classes=RESNET["classes"],
                             shard_size=RESNET["shard_size"])
    write_s = time.perf_counter() - t0
    pipe = ImageNetPipeline(data_dir, RESNET["batch"],
                            crop_size=RESNET["crop"], train=True)
    spe = pipe.steps_per_epoch
    steps = RESNET["epochs"] * spe
    sched = _resnet_schedule(spe)
    est = _resnet_estimator(0, "cuda", sched, model_dir=model_dir)
    est.engine.build()
    lr_log = _LrLog(est.engine.opt)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_fit = time.perf_counter()
    stats = est.fit(pipe, epochs=RESNET["epochs"], verbose=False,
                    profile=True, checkpoint_trigger=EveryEpoch())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    peak = torch.cuda.max_memory_allocated()
    pipe_stats = est.data_pipeline_stats()
    step_ms = [t for s in stats for t in s["profile"]["step_ms"]]
    losses = [s["train_loss"] for s in stats]
    want_lr = [sched.lr_at(k, 0.0) for k in range(steps)]
    if len(step_ms) != steps or not all(map(math.isfinite, losses)):
        fail(f"ResNet fit: {len(step_ms)} steps (expected {steps}), "
             f"losses {losses}")
    if lr_log.lrs != want_lr:
        fail(f"ResNet steps used lr {lr_log.lrs}, the schedule says "
             f"{want_lr}")
    ckpt = pipe_stats["ckpt"]
    if ckpt["saves"] < RESNET["epochs"] or ckpt["errors"]:
        fail(f"ResNet checkpoints: {ckpt}")
    eval_pipe = ImageNetPipeline(data_dir, RESNET["batch"],
                                 crop_size=RESNET["crop"], train=False)
    ev = est.evaluate(eval_pipe, verbose=False)
    fresh = _resnet_estimator(1, "cuda", sched)
    restored = fresh.load_checkpoint(model_dir)
    ev2 = fresh.evaluate(eval_pipe, verbose=False)
    if not math.isfinite(ev["loss"]) or ev2["loss"] != ev["loss"]:
        fail(f"ResNet restored loss {ev2['loss']} != trained {ev['loss']}")
    crops = next(eval_pipe._host_batches(False)).x[0][:64]
    logits = est.predict(crops, batch_size=64)
    if logits.shape != (len(crops), RESNET["classes"]) or \
            not np.isfinite(logits).all():
        fail(f"ResNet predict malformed: {logits.shape}")
    est.shutdown()
    fresh.shutdown()
    eval_pipe.close()
    del fresh
    median_ms = statistics.median(step_ms[1:])
    emit({"phase": "resnet_train",
          "model": "ResNet-50 v1.5, 1000 classes (bench_resnet50)",
          "entry": "TPUEstimator(resnet(50, 1000)).fit(ImageNetPipeline)",
          "compute_dtype": "bfloat16", "config": RESNET,
          "steps_per_epoch": spe, "steps": steps,
          "optimizer": "SGD(momentum=0.9), Warmup(40) -> Poly(2, 680)",
          "lr_per_step": lr_log.lrs, "train_loss": losses,
          "step_ms": step_ms, "first_step_ms": step_ms[0],
          "step_ms_median_after_first": median_ms,
          "step_ms_min_after_first": min(step_ms[1:]),
          "step_ms_max_after_first": max(step_ms[1:]),
          "steady_samples_per_s": RESNET["batch"] / (median_ms / 1e3),
          "fit_s": fit_s,
          "fit_samples_per_s": steps * RESNET["batch"] / fit_s,
          "batch_bytes": RESNET["batch"] * (RESNET["crop"] ** 2 * 3 + 4),
          "data_pipeline_stats": pipe_stats,
          "max_memory_allocated_bytes": peak,
          "evaluate_loss": ev["loss"], "restored_loss": ev2["loss"],
          "restored_from": os.path.basename(restored),
          "predict_shape": list(logits.shape), "card": card,
          "setup_s": setup_s, "write_data_s": write_s})
    return est, pipe, median_ms


def _launching_ops(prof):
    """For each correlation id of a kernel launch or copy, the names of the
    CPU ops around the runtime call that issued it, innermost first."""
    stacks = {}
    for evt in prof.events():
        if (evt.device_type != torch.autograd.DeviceType.CPU or not evt.id
                or not evt.name.startswith("cu")):
            continue
        names, parent = [], evt.cpu_parent
        while parent is not None:
            names.append(parent.name)
            parent = parent.cpu_parent
        stacks[evt.id] = names
    return stacks


def _resnet_op_class(name, ops):
    """The class of a device event of a ResNet step from the CPU ops that
    launched it: the optimizer, else the op (conv, BatchNorm, max-pool,
    anything else elementwise) and whether autograd's backward ran it."""
    if "memcpy" in name or "htod" in name:
        return "h2d_copy"
    ops = " ".join(ops).lower()
    if "optimizer.step" in ops:
        return "sgd"
    side = "backward" if "backward" in ops else "forward"
    for op, cls in (("convolution", "conv"), ("batch_norm", "batch_norm"),
                    ("max_pool", "max_pool")):
        if op in ops:
            return f"{cls}_{side}"
    return f"elementwise_{side}"


def resnet_step_flops(module, crop, batch):
    """The FLOPs of a ResNet training step from its conv and Dense shapes,
    2 a multiply-add: the forward, every weight gradient, and every input
    gradient but the stem's (its input is the batch)."""
    from analytics_zoo_tpu_torch.models.image.resnet import Conv
    macs = []

    def conv(m, inputs, out):
        macs.append((out[0].numel() * m.weight[0].numel(),
                     m is module.conv_init))

    hooks = [m.register_forward_hook(conv) for m in module.modules()
             if isinstance(m, Conv)]
    hooks.append(module.head.register_forward_hook(
        lambda m, i, o: macs.append((m.weight.numel(), False))))
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            module(torch.zeros(1, crop, crop, 3, dtype=torch.uint8,
                               device=module.head.weight.device))
    finally:
        module.train(was_training)
        for h in hooks:
            h.remove()
    fwd = 2.0 * sum(m for m, _ in macs)
    bwd = fwd + 2.0 * sum(m for m, stem in macs if not stem)
    return {"forward_flops_per_image": fwd, "layers": len(macs),
            "step_flops": (fwd + bwd) * batch}


def resnet_profile_phase(est, pipe, card, train_ms):
    """Where a ResNet-50 training step spends device time: torch.profiler
    over RESNET_PROFILE_STEPS steps fed by the prefetching pipeline after
    a warm step; kernel time by class, from the CPU op that launched each
    kernel, the top kernels,
    the idle share, the MFU of the fit's median step against the bf16
    peak, and the rate of the host pipeline alone over one epoch."""
    from torch.profiler import ProfilerActivity, profile
    eng = est.engine
    batches = pipe.epoch(prefetch=True)
    try:
        eng.train_batch(next(batches))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(RESNET_PROFILE_STEPS):
                eng.train_batch(next(batches))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        batches.close()
    dev_events = _device_events(prof)
    if not dev_events:
        fail("the profiler saw no device time in the ResNet steps")
    stacks = _launching_ops(prof)
    by_op, by_kernel, unattributed = {}, {}, 0
    for evt in dev_events:
        ms = evt.time_range.elapsed_us() / 1e3 / RESNET_PROFILE_STEPS
        ops = stacks.get(evt.id)
        if ops is None:
            unattributed += 1
            cls = "unattributed"
        else:
            cls = _resnet_op_class(evt.name.lower(), ops)
        by_op[cls] = by_op.get(cls, 0.0) + ms
        tot, n = by_kernel.get(evt.name, (0.0, 0))
        by_kernel[evt.name] = (tot + ms, n + 1)
    busy = _busy_ms(dev_events) / RESNET_PROFILE_STEPS
    flops = resnet_step_flops(est.module, RESNET["crop"], RESNET["batch"])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:24]
    # the host pipeline alone: one epoch through the pump, with no step
    # to wait for, against the step's rate
    t0 = time.perf_counter()
    fed = sum(1 for _ in pipe.epoch(prefetch=True))
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    emit({"phase": "resnet_profile", "batch": RESNET["batch"],
          "steps_profiled": RESNET_PROFILE_STEPS,
          "wall_ms_per_step": wall_ms / RESNET_PROFILE_STEPS,
          "device_busy_ms_per_step": busy,
          "device_idle_share": 1.0 - busy * RESNET_PROFILE_STEPS / wall_ms,
          "device_ms_by_class_per_step": by_op,
          "device_events_per_step": len(dev_events) / RESNET_PROFILE_STEPS,
          "device_events_unattributed": unattributed,
          "top_kernels_ms_per_step": [
              {"name": k[:160], "ms": v[0],
               "launches": v[1] / RESNET_PROFILE_STEPS} for k, v in top],
          **flops,
          "bound_ms": flops["step_flops"] / PEAK_BF16 * 1e3,
          "fit_step_ms_median": train_ms,
          "mfu": flops["step_flops"] / (train_ms / 1e3) / PEAK_BF16,
          "busy_mfu": flops["step_flops"] / (busy / 1e3) / PEAK_BF16,
          "pipeline": pipe.stats.snapshot(),
          "pipeline_alone": {
              "batches": fed, "s": feed_s, "batches_per_s": fed / feed_s,
              "MBps": fed * RESNET["batch"] * (RESNET["crop"] ** 2 * 3 + 4)
              / feed_s / 1e6,
              "steps_per_s_of_fit": 1e3 / train_ms},
          "card": card})


class _Switches:
    """Records, in call order, each ReLU's mask (output > 0) and each
    max-pool's argmax in a ResNet run, tagged with the block running (its
    input's mask too, on the first step); given another run's records, it
    imposes them instead: a ReLU keeps the elements that run kept, a
    max-pool takes the elements that run took. The two are the only
    switches of the network, so two runs with the same switches compute
    the same smooth function of the weights."""

    def __init__(self, module, impose=None):
        self.module, self.impose = module, impose
        self.relu, self.pool, self.block_in = [], [], {}
        self.identity = {name for name in module.block_names
                         if not getattr(module, name).project}
        self.step, self.block = 0, "stem"
        self._next_relu = self._next_pool = 0

    def _relu(self, x, inplace=False):
        mask = (x > 0).cpu()
        self.relu.append((self.step, self.block, mask))
        if self.impose is None:
            return self.inner_relu(x)
        step, block, want = self.impose.relu[self._next_relu]
        self._next_relu += 1
        assert (step, block) == (self.step, self.block), "switch order"
        return x * want.to(x.device, x.dtype)

    def _max_pool(self, x, kernel_size, stride, padding):
        if self.impose is None:
            out, idx = self.inner_pool(x, kernel_size, stride, padding,
                                       return_indices=True)
            self.pool.append(idx.cpu())
            return out
        idx = self.impose.pool[self._next_pool].to(x.device)
        self._next_pool += 1
        out = x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        return out.contiguous(memory_format=torch.channels_last)

    def __enter__(self):
        f = torch.nn.functional
        self.inner_relu, self.inner_pool = f.relu, f.max_pool2d
        f.relu, f.max_pool2d = self._relu, self._max_pool
        self.hooks = []
        for name in self.module.block_names:
            block = getattr(self.module, name)
            self.hooks.append(block.register_forward_pre_hook(
                partial(self._enter_block, name)))
            self.hooks.append(block.register_forward_hook(
                lambda *_: setattr(self, "block", "stem")))
        return self

    def _enter_block(self, name, module, inputs):
        self.block = name
        if self.step == 0:
            self.block_in[name] = (inputs[0] > 0).cpu()

    def __exit__(self, *exc):
        f = torch.nn.functional
        f.relu, f.max_pool2d = self.inner_relu, self.inner_pool
        for h in self.hooks:
            h.remove()
        if exc[0] is None and self.impose is not None:
            assert (self._next_relu, self._next_pool) == (
                len(self.impose.relu), len(self.impose.pool)), "switch count"


def _relu_flips(run, ref):
    """The first step's ReLU outputs that are zero in one run and not in
    the other: by call, summed, and distinct by block. An identity block's
    output ReLU passes on the flips its input carries (a block's last
    BatchNorm starts at scale 0, so its output is its input at the first
    step); a flip is distinct unless it sits where the block's input
    already differed."""
    calls, distinct = 0, {}
    last = {}
    for i, (step, block, _) in enumerate(ref.relu):
        if step == 0:
            last[block] = i
    for i, ((step, block, mask), (_, _, want)) in enumerate(
            zip(run.relu, ref.relu)):
        if step != 0:
            break
        flips = mask != want
        calls += int(flips.sum())
        if block in ref.identity and last[block] == i:
            flips &= run.block_in[block] == ref.block_in[block]
        distinct[block] = distinct.get(block, 0) + int(flips.sum())
    return {"summed_over_calls": calls,
            "distinct": sum(distinct.values()),
            "distinct_by_block": {k: v for k, v in distinct.items() if v}}


def _resnet_two_steps(dtype, dev, imgs, labels, impose=None):
    """Two ResNet-50 training steps from the seeded weights on ``dev``:
    the losses, the first step's gradients and the BatchNorm statistics
    after the second step, on the CPU, and the run's switches (ReLU masks
    and max-pool choices, imposed from ``impose`` when given)."""
    from analytics_zoo_tpu_torch.orca.learn.utils import Batch
    est = _resnet_estimator(5, dev, dtype=dtype, lr=0.01)
    eng = est.engine
    eng.build()
    losses, grads = [], None
    with _Switches(est.module, impose) as switches:
        for step in range(2):
            switches.step = step
            losses.append(float(eng.train_batch(Batch(
                x=(imgs[step],), y=(labels[step],), w=None))))
            if step == 0:
                grads = {n: p.grad.detach().cpu().clone()
                         for n, p in est.module.named_parameters()}
    stats = {n: b.detach().cpu().clone()
             for n, b in est.module.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return losses, grads, stats, switches


def _resnet_param_class(name, grad):
    if name.startswith("head."):
        return "head"
    return "conv" if grad.dim() == 4 else "batch_norm"


def resnet_vs_cpu_phase(card):
    """Two ResNet-50 training steps at crop 224 and batch RESNET_CPU_BATCH
    from the same weights and batches on the card and on the CPU, in f32
    (TF32 off) and in bf16 compute: losses, first-step gradients (the
    largest error of each class of parameter, relative to each
    parameter's largest gradient) and the BatchNorm statistics after the
    second step, held as TOL_RESNET says; each dtype's limits are shown to
    reject the other dtype's compute on the card. The ReLU outputs that
    are zero on one side only are counted. The witness: the card's f32
    steps again with the CPU's ReLU masks and max-pool choices imposed,
    held to TOL_RESNET["float32_switches_imposed"]."""
    rng = np.random.RandomState(8)
    n, crop = RESNET_CPU_BATCH, RESNET["crop"]
    imgs = rng.randint(0, 256, (2, n, crop, crop, 3)).astype(np.uint8)
    labels = rng.randint(0, RESNET["classes"], (2, n)).astype(np.int32)
    t0 = time.perf_counter()
    runs = {(dtype, where): _resnet_two_steps(dtype, where, imgs, labels)
            for dtype in (torch.float32, torch.bfloat16)
            for where in ("cpu", "cuda")}
    runs[("float32_switches_imposed", "cuda")] = _resnet_two_steps(
        torch.float32, "cuda", imgs, labels,
        impose=runs[(torch.float32, "cpu")][3])
    run_s = time.perf_counter() - t0

    def readings(card_run, cpu_run):
        (l_a, g_a, s_a, _), (l_b, g_b, s_b, _) = card_run, cpu_run
        out = {"loss": max(abs(a - b) / abs(b) for a, b in zip(l_a, l_b)),
               "stats": max(_rel_err(s_a[k], s_b[k]) for k in s_b)}
        for name in g_b:
            cls = "grad_" + _resnet_param_class(name, g_b[name])
            out[cls] = max(out.get(cls, 0.0), _rel_err(g_a[name], g_b[name]))
        return out

    result, failed = {}, []
    for key, card_key, dtype, other in (
            ("float32", torch.float32, torch.float32, torch.bfloat16),
            ("float32_switches_imposed", "float32_switches_imposed",
             torch.float32, torch.bfloat16),
            ("bfloat16", torch.bfloat16, torch.bfloat16, torch.float32)):
        limits = TOL_RESNET[key]
        card_run = runs[(card_key, "cuda")]
        cpu_run = runs[(dtype, "cpu")]
        got = readings(card_run, cpu_run)
        # the control: the card in the other dtype against this CPU run
        control = readings(runs[(other, "cuda")], cpu_run)
        rejected = all(control[k] > limits[k] for k in limits
                       if k != "loss")
        ok = (all(got[k] <= limits[k] for k in limits) and rejected
              and all(map(math.isfinite, card_run[0])))
        result[key] = {"loss_card": card_run[0], "loss_cpu": cpu_run[0],
                       "readings": got, "limits": limits,
                       "control": control, "control_rejected": rejected,
                       "relu_flips": _relu_flips(card_run[3], cpu_run[3]),
                       "relu_outputs_first_step": sum(
                           m.numel() for step, _, m in cpu_run[3].relu
                           if step == 0),
                       "ok": ok}
        if not ok:
            failed.append(key)
    emit({"phase": "resnet_vs_cpu", "batch": n, "crop": crop, "steps": 2,
          "optimizer": "SGD(lr=0.01, momentum=0.9)", **result,
          "run_s": run_s, "card": card})
    if failed:
        fail(f"ResNet training on the card disagrees with the CPU "
             f"({', '.join(failed)})")


# --- a user's torch ResNet-50 through Estimator.from_torch --------------------

class Bottleneck(torch.nn.Module):
    """torchvision's ResNet v1.5 bottleneck, as a user writes it without
    torchvision: 1x1, 3x3 (the stride), 1x1 to 4x the width, with a
    downsample Sequential (1x1 conv and BatchNorm) where the shape
    changes."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * self.expansion, 1,
                               bias=False)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class TorchResNet(torch.nn.Module):
    """torchvision's ResNet in plain torch with torch's default init: a
    7x7/2 stem (padding 3) and a 3x3/2 max-pool (padding 1), four stages of
    bottlenecks at widths ``width`` x (1, 2, 4, 8), AdaptiveAvgPool2d,
    ``torch.flatten(x, 1)`` and a Linear head. ``TorchResNet()`` is
    ResNet-50 with 1000 classes (25,557,032 parameters)."""

    def __init__(self, layers=(3, 4, 6, 3), width=64, num_classes=1000):
        super().__init__()
        nn = torch.nn
        self.inplanes = width
        self.conv1 = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = self._make_layer(width, layers[0])
        self.layer2 = self._make_layer(width * 2, layers[1], stride=2)
        self.layer3 = self._make_layer(width * 4, layers[2], stride=2)
        self.layer4 = self._make_layer(width * 8, layers[3], stride=2)
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(width * 8 * Bottleneck.expansion, num_classes)

    def _make_layer(self, planes, blocks, stride=1):
        nn = torch.nn
        downsample = None
        if stride != 1 or self.inplanes != planes * Bottleneck.expansion:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * Bottleneck.expansion, 1,
                          stride=stride, bias=False),
                nn.BatchNorm2d(planes * Bottleneck.expansion))
        layers = [Bottleneck(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * Bottleneck.expansion
        layers += [Bottleneck(self.inplanes, planes)
                   for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = torch.flatten(self.avgpool(x), 1)
        return self.fc(x)


def _torch_images(n, seed):
    """``n`` seeded images as a user's pipeline hands them to the model:
    uint8 pixels normalised by the ImageNet mean and std, f32 NCHW."""
    from analytics_zoo_tpu_torch.orca.data.image import (IMAGENET_MEAN,
                                                         IMAGENET_STD)
    rng = np.random.RandomState(seed)
    size = TORCH_RESNET["size"]
    x = rng.randint(0, 256, (n, 3, size, size), dtype=np.uint8)
    x = x.astype(np.float32)
    x -= np.asarray(IMAGENET_MEAN, np.float32)[:, None, None]
    x /= np.asarray(IMAGENET_STD, np.float32)[:, None, None]
    y = rng.randint(0, TORCH_RESNET["classes"], n).astype(np.int64)
    return x, y


def _sgd_creator(model, config):
    return torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9,
                           weight_decay=1e-4)


def _torch_estimator(model_creator=None, **kwargs):
    """``Estimator.from_torch`` with the phase's creators: the user's
    ResNet-50, SGD (lr 0.1, momentum 0.9, weight decay 1e-4) and
    ``nn.CrossEntropyLoss`` as a class."""
    from analytics_zoo_tpu_torch.orca.learn.pytorch import Estimator
    return Estimator.from_torch(
        model_creator=model_creator or (lambda config: TorchResNet()),
        optimizer_creator=_sgd_creator,
        loss_creator=torch.nn.CrossEntropyLoss, **kwargs)


def torch_estimator_train_phase(card, root):
    """BASELINE config #2's entry point: a user's torch ResNet-50 through
    ``Estimator.from_torch`` and a ``data_creator`` returning an unshuffled
    DataLoader of 1,024 seeded images; ``fit`` 2 epochs of 4 steps at batch
    256 (shuffled by the native xoshiro order) with an every-epoch
    checkpoint; a fresh estimator restores the last checkpoint and
    evaluates to the trained loss exactly, and predicts the same logits."""
    from torch.utils.data import DataLoader, TensorDataset

    from analytics_zoo_tpu_torch.orca.learn.trigger import EveryEpoch
    cfg = TORCH_RESNET
    t0 = time.perf_counter()
    x, y = _torch_images(cfg["images"], 0)
    dataset = TensorDataset(torch.from_numpy(x), torch.from_numpy(y))

    def data_creator(config, batch_size):
        return DataLoader(dataset, batch_size=batch_size, shuffle=False)
    model_dir = os.path.join(root, "ckpt")
    est = _torch_estimator(model_dir=model_dir)
    n_params = sum(p.numel() for p in est.module.parameters())
    if n_params != TORCH_RESNET_PARAMS:
        fail(f"the user's ResNet-50 has {n_params} parameters, not "
             f"{TORCH_RESNET_PARAMS}")
    setup_s = time.perf_counter() - t0
    tf32 = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_fit = time.perf_counter()
    stats = est.fit(data_creator, epochs=cfg["epochs"],
                    batch_size=cfg["batch"], checkpoint_trigger=EveryEpoch(),
                    profile=True, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    peak = torch.cuda.max_memory_allocated()
    pipe_stats = est.data_pipeline_stats()
    step_ms = [t for s in stats for t in s["profile"]["step_ms"]]
    losses = [s["train_loss"] for s in stats]
    steps = cfg["epochs"] * cfg["images"] // cfg["batch"]
    if len(step_ms) != steps or not all(map(math.isfinite, losses)):
        fail(f"from_torch fit: {len(step_ms)} steps (expected {steps}), "
             f"losses {losses}")
    ckpt = pipe_stats["ckpt"]
    if ckpt["saves"] < cfg["epochs"] or ckpt["errors"]:
        fail(f"from_torch checkpoints: {ckpt}")
    ev = est.evaluate(data_creator, batch_size=cfg["batch"], verbose=False)
    fresh = _torch_estimator()
    restored = fresh.load_checkpoint(model_dir)
    ev2 = fresh.evaluate(data_creator, batch_size=cfg["batch"],
                         verbose=False)
    if not math.isfinite(ev["loss"]) or ev2["loss"] != ev["loss"]:
        fail(f"from_torch restored loss {ev2['loss']} != trained "
             f"{ev['loss']}")
    logits = fresh.predict(data_creator, batch_size=cfg["batch"])
    want = est.predict(data_creator, batch_size=cfg["batch"])
    if logits.shape != (cfg["images"], cfg["classes"]) or \
            not np.isfinite(logits).all() or \
            not np.array_equal(logits, want):
        fail(f"from_torch predict: {logits.shape}, finite "
             f"{np.isfinite(logits).all()}, equal to the trained "
             f"estimator's {np.array_equal(logits, want)}")
    est.shutdown()
    fresh.shutdown()
    del fresh, dataset
    median_ms = statistics.median(step_ms[1:])
    emit({"phase": "torch_estimator_train",
          "model": "a user's torch ResNet-50 (torchvision v1.5 layout, "
                   "plain torch, torch's default init), 1000 classes",
          "entry": "Estimator.from_torch(model_creator, optimizer_creator, "
                   "loss_creator=nn.CrossEntropyLoss).fit(data_creator -> "
                   "DataLoader)",
          "parameters": n_params, "compute_dtype": "float32",
          "tf32": tf32, "config": cfg, "steps": steps,
          "optimizer": "torch.optim.SGD(lr=0.1, momentum=0.9, "
                       "weight_decay=1e-4)",
          "train_loss": losses, "step_ms": step_ms,
          "first_step_ms": step_ms[0],
          "step_ms_median_after_first": median_ms,
          "step_ms_min_after_first": min(step_ms[1:]),
          "step_ms_max_after_first": max(step_ms[1:]),
          "steady_samples_per_s": cfg["batch"] / (median_ms / 1e3),
          "fit_s": fit_s, "fit_samples_per_s": steps * cfg["batch"] / fit_s,
          "batch_bytes": cfg["batch"] * (3 * cfg["size"] ** 2 * 4 + 4),
          "data_pipeline_stats": pipe_stats,
          "max_memory_allocated_bytes": peak,
          "evaluate_loss": ev["loss"], "restored_loss": ev2["loss"],
          "restored_from": os.path.basename(restored),
          "predict_shape": list(logits.shape), "card": card,
          "setup_s": setup_s})
    return est, x, y, median_ms


def torch_resnet_step_flops(module, size, batch):
    """The FLOPs of a training step of a torch ResNet from its conv and
    Linear shapes, 2 a multiply-add: the forward, every weight gradient,
    and every input gradient but the stem's (its input is the batch)."""
    macs = []

    def count(m, inputs, out):
        macs.append((out.numel() * m.weight[0].numel(), m is module.conv1))

    hooks = [m.register_forward_hook(count) for m in module.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            module(torch.zeros(1, 3, size, size,
                               device=module.fc.weight.device))
    finally:
        module.train(was_training)
        for h in hooks:
            h.remove()
    fwd = 2.0 * sum(m for m, _ in macs)
    bwd = fwd + 2.0 * sum(m for m, stem in macs if not stem)
    return {"forward_flops_per_image": fwd, "layers": len(macs),
            "step_flops": (fwd + bwd) * batch}


def _torch_op_class(name, ops):
    """``_resnet_op_class``, with the head's GEMMs (addmm, mm) apart from
    the elementwise passes."""
    cls = _resnet_op_class(name, ops)
    joined = " ".join(ops).lower()
    if cls.startswith("elementwise") and ("addmm" in joined
                                          or "aten::mm" in joined):
        return cls.replace("elementwise", "linear")
    return cls


def torch_estimator_profile_phase(est, x, y, card, train_ms):
    """Where a step of the user's f32 ResNet-50 spends device time:
    torch.profiler over TORCH_PROFILE_STEPS steps fed through the infeed
    pump after a warm step; kernel time by class (from the CPU op that
    launched each kernel), the idle share, and the step's FLOPs against the
    H100's f32 peak outside the tensor cores (TF32 is off). The epoch runs
    over the images twice (two chunks of the same arrays, no copy), so the
    pump still assembles and copies batches inside the window."""
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.orca.data.chunked import ChunkedArray
    from analytics_zoo_tpu_torch.orca.learn import utils as learn_utils
    cfg = TORCH_RESNET
    eng = est.engine
    it = learn_utils.BatchIterator(
        {"x": (ChunkedArray([x, x]),), "y": (ChunkedArray([y, y]),)},
        cfg["batch"], shuffle=True, device=est.device)
    batches = it.epoch(prefetch=True)
    try:
        eng.train_batch(next(batches))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TORCH_PROFILE_STEPS):
                eng.train_batch(next(batches))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        batches.close()
    dev_events = _device_events(prof)
    if not dev_events:
        fail("the profiler saw no device time in the from_torch steps")
    stacks = _launching_ops(prof)
    by_op, by_kernel, unattributed = {}, {}, 0
    for evt in dev_events:
        ms = evt.time_range.elapsed_us() / 1e3 / TORCH_PROFILE_STEPS
        ops = stacks.get(evt.id)
        if ops is None:
            unattributed += 1
            cls = "unattributed"
        else:
            cls = _torch_op_class(evt.name.lower(), ops)
        by_op[cls] = by_op.get(cls, 0.0) + ms
        tot, n = by_kernel.get(evt.name, (0.0, 0))
        by_kernel[evt.name] = (tot + ms, n + 1)
    busy = _busy_ms(dev_events) / TORCH_PROFILE_STEPS
    flops = torch_resnet_step_flops(est.module, cfg["size"], cfg["batch"])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:24]
    emit({"phase": "torch_estimator_profile", "batch": cfg["batch"],
          "steps_profiled": TORCH_PROFILE_STEPS,
          "wall_ms_per_step": wall_ms / TORCH_PROFILE_STEPS,
          "device_busy_ms_per_step": busy,
          "device_idle_share": 1.0 - busy * TORCH_PROFILE_STEPS / wall_ms,
          "device_ms_by_class_per_step": by_op,
          "device_events_per_step": len(dev_events) / TORCH_PROFILE_STEPS,
          "device_events_unattributed": unattributed,
          "top_kernels_ms_per_step": [
              {"name": k[:160], "ms": v[0],
               "launches": v[1] / TORCH_PROFILE_STEPS} for k, v in top],
          **flops,
          "fp32_peak_flops": PEAK_F32_CUDA_CORES,
          "fp32_peak": "H100 SXM dense FP32 outside the tensor cores "
                       "(TF32 is off)",
          "bound_ms": flops["step_flops"] / PEAK_F32_CUDA_CORES * 1e3,
          "fit_step_ms_median": train_ms,
          "fp32_share": flops["step_flops"] / (train_ms / 1e3)
          / PEAK_F32_CUDA_CORES,
          "busy_fp32_share": flops["step_flops"] / (busy / 1e3)
          / PEAK_F32_CUDA_CORES,
          "pipeline": it.stats.snapshot(), "card": card})


def _torch_two_steps(dev, state, imgs, labels, order=(0, 1),
                     dtype=torch.float32):
    """Two steps of the phase's creators on ``dev`` from ``state``, the
    batches taken in ``order``: each step's loss, and the BatchNorm
    statistics after each step, on the CPU in float64."""
    from analytics_zoo_tpu_torch.orca.learn.utils import Batch

    def model_creator(config):
        model = TorchResNet()
        model.load_state_dict(state)
        return model.to(dtype)
    est = _torch_estimator(model_creator, device=dev)
    eng = est.engine
    eng.build()
    host = np.float64 if dtype == torch.float64 else np.float32
    losses, stats = [], []
    for s in order:
        losses.append(float(eng.train_batch(Batch(
            x=(imgs[s].astype(host),), y=(labels[s],), w=None))))
        stats.append({n: b.detach().double().cpu().clone()
                      for n, b in est.module.named_buffers()
                      if n.endswith(("running_mean", "running_var"))})
    return losses, stats


def torch_estimator_vs_cpu_phase(card):
    """Two steps of the phase's creators at batch TORCH_CPU_BATCH, 224 px,
    from one state_dict and the same batches on the card and on the CPU,
    f32 with TF32 off on both: losses and BatchNorm statistics held to
    TOL_TORCH_RESNET, each against a control (the card with the two
    batches swapped) that must miss every limit. From torch's default init
    (the train phase's) the first step is held; the second step's
    readings are reported beside the CPU's own f32-vs-f64 readings. From
    the same weights with every bottleneck's last BatchNorm scale at 0
    (torchvision's ``zero_init_residual``) the second step is held."""
    torch.manual_seed(3)
    default = TorchResNet().state_dict()
    zero_res = {k: (torch.zeros_like(v) if k.endswith("bn3.weight") else v)
                for k, v in default.items()}
    x, y = _torch_images(2 * TORCH_CPU_BATCH, 9)
    imgs = x.reshape((2, TORCH_CPU_BATCH) + x.shape[1:])
    labels = y.reshape(2, TORCH_CPU_BATCH)
    t0 = time.perf_counter()
    result, failed = {}, []
    for name, state, held in (("default_init", default, 0),
                              ("zero_init_residual", zero_res, 1)):
        card_run = _torch_two_steps("cuda", state, imgs, labels)
        cpu_run = _torch_two_steps("cpu", state, imgs, labels)
        control_run = _torch_two_steps("cuda", state, imgs, labels, (1, 0))

        def readings(run, step, ref=cpu_run):
            (l_a, s_a), (l_b, s_b) = run, ref
            return {"loss": abs(l_a[step] - l_b[step]) / abs(l_b[step]),
                    "stats": max(_rel_err(s_a[step][k], s_b[step][k])
                                 for k in s_b[step])}
        limits = TOL_TORCH_RESNET
        got, control = readings(card_run, held), readings(control_run, held)
        rejected = all(control[k] > limits[k] for k in limits)
        ok = (all(got[k] <= limits[k] for k in limits) and rejected
              and all(map(math.isfinite, card_run[0])))
        result[name] = {"held_step": held + 1, "loss_card": card_run[0],
                        "loss_cpu": cpu_run[0], "readings": got,
                        "limits": limits, "control_readings": control,
                        "control_rejected": rejected, "ok": ok}
        if held == 0:
            f64_run = _torch_two_steps("cpu", state, imgs, labels,
                                       dtype=torch.float64)
            result[name]["step2_reported"] = {
                "card_vs_cpu": readings(card_run, 1),
                "cpu_float32_vs_float64": readings(cpu_run, 1, f64_run),
                "control": readings(control_run, 1)}
        if not ok:
            failed.append(name)
    emit({"phase": "torch_estimator_vs_cpu", "batch": TORCH_CPU_BATCH,
          "size": TORCH_RESNET["size"], "steps": 2,
          "optimizer": "torch.optim.SGD(lr=0.1, momentum=0.9, "
                       "weight_decay=1e-4)",
          "control": "the card with the two batches swapped", **result,
          "run_s": time.perf_counter() - t0, "card": card})
    if failed:
        fail(f"from_torch steps on the card disagree with the CPU "
             f"({', '.join(failed)})")


def torch_operator_fit_phase(x, y, card):
    """One epoch of 4 steps at batch 256 through ``training_operator_cls``:
    a TrainingOperator subclass whose ``train_batch`` calls ``super()`` and
    records each batch's index and real rows."""
    from torch.utils.data import DataLoader, TensorDataset

    from analytics_zoo_tpu_torch.orca.learn.pytorch import TrainingOperator

    class Recording(TrainingOperator):
        def setup(self, config):
            self.calls = []

        def train_batch(self, batch, batch_info):
            out = super().train_batch(batch, batch_info)
            self.calls.append((batch_info["batch_idx"], out["num_samples"],
                               out["train_loss"]))
            return out
    dataset = TensorDataset(torch.from_numpy(x), torch.from_numpy(y))
    est = _torch_estimator(training_operator_cls=Recording)
    t0 = time.perf_counter()
    stats = est.fit(lambda config, batch_size: DataLoader(
        dataset, batch_size=batch_size, shuffle=False), epochs=1,
        batch_size=TORCH_RESNET["batch"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    calls = est._operator.calls
    if [c[0] for c in calls] != [0, 1, 2, 3] or \
            sum(c[1] for c in calls) != len(x) or \
            not all(math.isfinite(c[2]) for c in calls):
        fail(f"training operator: {calls}")
    emit({"phase": "torch_operator_fit", "calls": calls, "stats": stats,
          "fit_s": fit_s, "card": card})


def torch_xshards_fit_phase(x, y, card):
    """XShards of 512 images in 4 round-robin partitions: the shuffled
    batch stream over them equals the stream over their concatenation
    (in partition order); ``fit`` 1 epoch at batch 128 on the card; and
    ``predict`` returns XShards whose predictions equal those over the
    concatenated arrays."""
    from analytics_zoo_tpu_torch.orca.data import HostXShards, XShards
    from analytics_zoo_tpu_torch.orca.learn import utils as learn_utils
    n, batch = TORCH_XSHARDS_IMAGES, TORCH_XSHARDS_BATCH
    shards = XShards.partition({"x": x[:n], "y": y[:n]}, num_shards=4)
    parts = shards.collect()
    cat = {k: np.concatenate([p[k] for p in parts]) for k in ("x", "y")}
    t0 = time.perf_counter()
    chunked = learn_utils.data_to_iterator(shards, batch, shuffle=True)
    flat = learn_utils.data_to_iterator(cat, batch, shuffle=True)
    compared = 0
    for a, b in zip(chunked._host_batches(True), flat._host_batches(True)):
        if not all(np.array_equal(u, v) for u, v in zip(a.leaves(),
                                                        b.leaves())):
            fail(f"XShards batch {compared} differs from the arrays' one")
        compared += 1
    if compared != n // batch:
        fail(f"XShards stream: {compared} batches")
    stream_s = time.perf_counter() - t0
    est = _torch_estimator()
    t0 = time.perf_counter()
    stats = est.fit(shards, epochs=1, batch_size=batch, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    pred = est.predict(shards, batch_size=batch)
    want = est.predict(cat["x"], batch_size=batch)
    got = (np.concatenate([p["prediction"] for p in pred.collect()])
           if isinstance(pred, HostXShards) else None)
    if got is None or pred.num_partitions() != 4 or \
            not np.array_equal(got, want) or \
            not math.isfinite(stats[0]["train_loss"]):
        fail("XShards predict differs from the arrays' predict, or the "
             f"fit failed: {stats}")
    emit({"phase": "torch_xshards_fit", "images": n, "partitions": 4,
          "batch": batch, "batches_compared": compared,
          "stream_s": stream_s, "stats": stats, "fit_s": fit_s,
          "predict_rows": int(len(got)), "card": card})


# --- the fraud-detection MLP (BASELINE #3) through NNFrames and Keras -------

def synthetic_fraud(n, n_features, fraud_rate, seed):
    """examples/nnframes/fraud_detection_mlp.py's synthetic_fraud."""
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) < fraud_rate).astype(np.float32)
    x = rng.randn(n, n_features).astype(np.float32)
    x[y == 1, :5] += 1.5          # separable signal on 5 features
    return x, y


def _fraud_frames():
    """The example's DataFrame and its 10 % holdout (random_state 0)."""
    import pandas as pd
    cfg = FRAUD
    x, y = synthetic_fraud(cfg["rows"], cfg["features"], cfg["fraud_rate"],
                           cfg["seed"])
    df = pd.DataFrame({"features": list(x), "label": y})
    holdout = df.sample(frac=cfg["holdout"], random_state=0)
    return df.drop(holdout.index), holdout


def _fraud_net(seed=0, widths=None, head=None):
    """The fraud MLP with the port's Keras API, its initial weights drawn
    on the CPU from ``torch.manual_seed(seed)`` (a lazy width would
    otherwise draw on the device it first sees). ``head``: layers put
    before the Dense stack."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    widths = widths or FRAUD["widths"]
    torch.manual_seed(seed)
    net = Sequential(list(head or []) +
                     [Dense(w, activation="relu") for w in widths] +
                     [Dense(1, activation="sigmoid")])
    module = net.to_module()
    with torch.no_grad():
        if head is None:
            module(torch.zeros(1, FRAUD["features"]))
        else:
            module(*[torch.zeros(1) for _ in range(FRAUD["features"])])
    return net


def _on_card(module):
    return all(p.device.type == "cuda" for p in module.parameters())


def rank_auc(pred, label):
    """The example's rank-based AUC."""
    order = np.argsort(pred)
    rank = np.empty_like(order, np.float64)
    rank[order] = np.arange(1, len(pred) + 1)
    pos, neg = label.sum(), (1 - label).sum()
    return float((rank[label == 1].sum() - pos * (pos + 1) / 2) /
                 max(pos * neg, 1))


def fraud_step_flops(module, batch):
    """A training step's FLOPs from the Linear shapes, 2 a multiply-add:
    the forward, every weight gradient, and every input gradient but the
    first layer's (its input is the batch)."""
    linears = [m for m in module.modules() if isinstance(m, torch.nn.Linear)]
    macs = [m.in_features * m.out_features for m in linears]
    fwd = 2.0 * batch * sum(macs)
    return {"forward_flops": fwd, "step_flops": 2 * fwd
            + 2.0 * batch * sum(macs[1:]),
            "parameters": sum(p.numel() for p in module.parameters())}


def fraud_nnframes_train_phase(card):
    """NNEstimator(Sequential(...).to_module(), "binary_crossentropy")
    .setBatchSize(16384).setMaxEpoch(3).fit(train_df), then
    NNModel.transform(holdout_df): fit samples/s over the whole call (the
    DataFrame -> array conversion, which fit repeats inside, timed apart),
    transform rows/s, the holdout AUC against its limits; then the
    underlying estimator re-fits 2 epochs with per-step times for the
    steady rate, as bench.py's bench_fraud_mlp re-runs it."""
    from analytics_zoo_tpu_torch.pipeline.nnframes import NNEstimator
    from analytics_zoo_tpu_torch.pipeline.nnframes.nn_classifier import \
        _col_to_array
    cfg = FRAUD
    train, holdout = _fraud_frames()
    net = _fraud_net()
    est = (NNEstimator(net.to_module(), "binary_crossentropy")
           .setBatchSize(cfg["batch"]).setMaxEpoch(cfg["epochs"]))
    t0 = time.perf_counter()
    x = _col_to_array(train, "features")
    y = _col_to_array(train, "label")
    convert_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = est.fit(train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    inner = model.estimator
    if not _on_card(inner.module):
        fail("NNEstimator did not train on the card")
    t0 = time.perf_counter()
    scored = model.setBatchSize(cfg["batch"]).transform(holdout)
    transform_s = time.perf_counter() - t0
    pred = np.asarray(list(scored["prediction"]), np.float32).reshape(-1)
    auc = rank_auc(pred, holdout["label"].to_numpy(np.float32))
    losses = [s["train_loss"] for s in inner.train_stats]
    steps = inner.engine.step
    prof = inner.fit({"x": x, "y": y}, epochs=2, batch_size=cfg["batch"],
                     verbose=False, profile=True)
    step_ms = [t for s in prof for t in s["profile"]["step_ms"]]
    steady_ms = statistics.median(step_ms[1:])
    peak = torch.cuda.max_memory_allocated()
    checks = {
        "prediction_shape": pred.shape == (len(holdout),),
        "finite": bool(np.isfinite(pred).all())
        and all(map(math.isfinite, losses)),
        "auc_vs_port_cpu": abs(auc - FRAUD_AUC_PORT_CPU) <= FRAUD_AUC_SAME,
        "auc_vs_jax": auc >= FRAUD_AUC_JAX - FRAUD_AUC_MARGIN}
    n = len(train)
    emit({"phase": "fraud_nnframes_train",
          "model": "Keras Sequential Dense 256-128-64-1 (ReLU, sigmoid), "
                   "29 features, f32",
          "entry": "NNEstimator(net.to_module(), 'binary_crossentropy')"
                   ".setBatchSize(16384).setMaxEpoch(3).fit(df) -> "
                   "NNModel.transform(holdout)",
          "rows": n, "holdout_rows": len(holdout),
          "holdout_fraud": int(holdout["label"].sum()),
          "batch": cfg["batch"], "epochs": cfg["epochs"], "steps": steps,
          "train_loss": losses, "fit_s": fit_s,
          "fit_samples_per_s": n * cfg["epochs"] / fit_s,
          "convert_s": convert_s,
          "fit_samples_per_s_without_convert":
              n * cfg["epochs"] / (fit_s - convert_s),
          "transform_s": transform_s,
          "transform_rows_per_s": len(holdout) / transform_s,
          "step_ms": step_ms, "steady_step_ms": steady_ms,
          "steady_samples_per_s": cfg["batch"] / steady_ms * 1e3,
          "auc": auc, "auc_port_cpu": FRAUD_AUC_PORT_CPU,
          "auc_same_limit": FRAUD_AUC_SAME, "auc_jax_cpu": FRAUD_AUC_JAX,
          "auc_margin": FRAUD_AUC_MARGIN, "checks": checks,
          "peak_memory_bytes": peak,
          **fraud_step_flops(inner.module, cfg["batch"]), "card": card})
    if not all(checks.values()):
        fail(f"fraud NNFrames training failed its checks: {checks}")
    return inner, x, y


def _is_copy(name):
    return "memcpy" in name or "htod" in name


def _fraud_op_class(name, ops):
    """The class of a device event of a fraud MLP step: the copy, Adam,
    the GEMMs (cuBLAS kernels, forward or backward), the loss (forward:
    inside the ``loss`` range the phase opens; backward: autograd nodes
    other than the Linear, ReLU and sigmoid ones), else elementwise."""
    if _is_copy(name):
        return "h2d_copy"
    ops_s = " ".join(ops).lower()
    if "optimizer.step" in ops_s:
        return "adam"
    side = "backward" if "backward" in ops_s else "forward"
    if "gemm" in name or "cutlass" in name or "xmma" in name:
        return f"gemm_{side}"
    if side == "forward":
        return "loss_forward" if "loss" in ops else "elementwise_forward"
    if any(k in ops_s for k in ("addmmbackward", "relubackward",
                                "thresholdbackward", "sigmoidbackward",
                                "tbackward", "accumulategrad")):
        return "elementwise_backward"
    return "loss_backward"


def fraud_profile_phase(inner, x, y, card):
    """torch.profiler over FRAUD_PROFILE_STEPS steps after a warm step,
    fed through the infeed pump: device busy and idle share, kernels a
    step, device ms a step by class, and the step's FLOPs against the f32
    peak. The loss runs inside a ``loss`` record_function here only, so
    that its forward kernels can be told apart."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from analytics_zoo_tpu_torch.orca.learn import utils as learn_utils
    eng = inner.engine
    loss_fn = eng.loss_fn

    def traced_loss(y_true, y_pred):
        with record_function("loss"):
            return loss_fn(y_true, y_pred)
    eng.loss_fn = traced_loss
    it = learn_utils.BatchIterator({"x": (x,), "y": (y,)}, FRAUD["batch"],
                                   shuffle=True, device=inner.device)
    batches = it.epoch(prefetch=True)
    try:
        eng.train_batch(next(batches))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(FRAUD_PROFILE_STEPS):
                eng.train_batch(next(batches))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        batches.close()
        eng.loss_fn = loss_fn
    dev_events = _device_events(prof)
    if not dev_events:
        fail("the profiler saw no device time in the fraud steps")
    stacks = _launching_ops(prof)
    by_class, by_kernel, unattributed = {}, {}, 0
    n = FRAUD_PROFILE_STEPS
    for evt in dev_events:
        ms = evt.time_range.elapsed_us() / 1e3 / n
        ops = stacks.get(evt.id)
        if ops is None and not _is_copy(evt.name.lower()):
            unattributed += 1
            cls = "unattributed"
        else:
            cls = _fraud_op_class(evt.name.lower(), ops or [])
        by_class[cls] = by_class.get(cls, 0.0) + ms
        tot, k = by_kernel.get(evt.name, (0.0, 0))
        by_kernel[evt.name] = (tot + ms, k + 1)
    busy = _busy_ms(dev_events) / n
    flops = fraud_step_flops(inner.module, FRAUD["batch"])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:16]
    emit({"phase": "fraud_profile", "batch": FRAUD["batch"],
          "steps_profiled": n, "wall_ms_per_step": wall_ms / n,
          "device_busy_ms_per_step": busy,
          "device_idle_share": 1.0 - busy * n / wall_ms,
          "kernels_per_step": len(dev_events) / n,
          "device_ms_by_class_per_step": by_class,
          "device_events_unattributed": unattributed,
          "top_kernels_ms_per_step": [
              {"name": k[:160], "ms": v[0], "launches": v[1] / n}
              for k, v in top],
          **flops, "fp32_peak_flops": PEAK_F32_CUDA_CORES,
          "bound_ms": flops["step_flops"] / PEAK_F32_CUDA_CORES * 1e3,
          "busy_fp32_share": flops["step_flops"] / (busy / 1e3)
          / PEAK_F32_CUDA_CORES,
          "pipeline": it.stats.snapshot(), "card": card})


def _fraud_steps(dev, state, batches, optimizer="adam"):
    """Train steps of the fraud MLP on ``dev`` from ``state``, one per
    batch in order: each step's loss, and each step's gradients and the
    parameters after it, on the CPU."""
    from analytics_zoo_tpu_torch.orca.learn.estimator import TPUEstimator
    from analytics_zoo_tpu_torch.orca.learn.utils import Batch
    net = _fraud_net()
    net.to_module().load_state_dict(state)
    est = TPUEstimator(net.to_module(), loss="binary_crossentropy",
                       optimizer=optimizer, device=dev)
    est.engine.build()
    losses, grads, params = [], [], []
    for bx, by in batches:
        losses.append(float(est.engine.train_batch(
            Batch(x=(bx,), y=(by,), w=None))))
        grads.append({n: p.grad.detach().cpu().clone()
                      for n, p in est.module.named_parameters()})
        params.append({n: p.detach().cpu().clone()
                       for n, p in est.module.named_parameters()})
    return losses, grads, params


def _fraud_batches(count, batch, seed):
    x, y = synthetic_fraud(count * batch, FRAUD["features"],
                           FRAUD["fraud_rate"], seed)
    return [(x[i * batch:(i + 1) * batch], y[i * batch:(i + 1) * batch,
                                               None])
            for i in range(count)]


def fraud_vs_cpu_phase(card, dev="cuda"):
    """Two Adam steps of the fraud MLP at batch 16384, f32 with TF32 off,
    on the card and on the CPU from the same weights: each step's loss
    (relative) and gradients (the largest error of a parameter's gradient
    relative to its largest entry) held to TOL_FRAUD, against a control,
    the card with the two batches swapped, that must miss every limit."""
    state = {k: v.clone() for k, v in
             _fraud_net().to_module().state_dict().items()}
    batches = _fraud_batches(2, FRAUD["batch"], seed=11)
    t0 = time.perf_counter()
    card_run = _fraud_steps(dev, state, batches)
    cpu_run = _fraud_steps("cpu", state, batches)
    control_run = _fraud_steps(dev, state, batches[::-1])

    def readings(run, step):
        return {"loss": abs(run[0][step] - cpu_run[0][step])
                / abs(cpu_run[0][step]),
                "grad": max(_rel_err(run[1][step][k], cpu_run[1][step][k])
                            for k in cpu_run[1][step])}
    got = [readings(card_run, s) for s in (0, 1)]
    control = [readings(control_run, s) for s in (0, 1)]
    held = all(r[k] <= TOL_FRAUD[k] for r in got for k in TOL_FRAUD)
    rejected = all(r[k] > TOL_FRAUD[k] for r in control for k in TOL_FRAUD)
    emit({"phase": "fraud_vs_cpu", "batch": FRAUD["batch"], "steps": 2,
          "optimizer": "adam (NNEstimator's default)",
          "loss_card": card_run[0], "loss_cpu": cpu_run[0],
          "readings": got, "limits": TOL_FRAUD,
          "control": "the card with the two batches swapped",
          "control_readings": control, "control_rejected": rejected,
          "run_s": time.perf_counter() - t0, "card": card})
    if not (held and rejected and all(map(math.isfinite, card_run[0]))):
        fail(f"fraud steps on the card disagree with the CPU: {got}, "
             f"control {control}")


def _kaggle_csvs(root):
    """KERAS_CSV's rows in Kaggle's creditcard.csv schema (Time, V1..V28,
    Amount, Class), fraud as synthetic_fraud makes it, in KERAS_CSV
    ["files"] files."""
    import pandas as pd
    cfg = KERAS_CSV
    x, y = synthetic_fraud(cfg["rows"], 30, FRAUD["fraud_rate"], seed=5)
    cols = ["Time"] + [f"V{i}" for i in range(1, 29)] + ["Amount"]
    df = pd.DataFrame(x, columns=cols)
    df["Class"] = y.astype(np.int64)
    per = cfg["rows"] // cfg["files"]
    for i in range(cfg["files"]):
        df.iloc[i * per:(i + 1) * per].to_csv(
            os.path.join(root, f"creditcard-{i}.csv"), index=False)
    return cols[1:], ["Class"]


def keras_csv_fit_phase(card, root):
    """The fraud MLP through the port's Keras API over read_csv XShards:
    4 CSV files of KERAS_CSV rows read into XShards; ``Sequential([Lambda
    stacking the 29 feature columns, Dense 256, 128, 64, 1]).compile
    ("adam", "binary_crossentropy")``, ``set_tensorboard``,
    ``fit(shards, feature_cols, label_cols, batch_size=16384)``: one
    ``Loss`` scalar a step in ``get_train_summary``; ``predict`` on XShards;
    ``save_weights`` -> a fresh net's ``load_weights`` evaluates to the same
    loss exactly."""
    from analytics_zoo_tpu_torch.orca.data.pandas import read_csv
    from analytics_zoo_tpu_torch.pipeline.api import autograd
    cfg = KERAS_CSV
    data_dir = os.path.join(root, "csv")
    os.makedirs(data_dir)
    feature_cols, label_cols = _kaggle_csvs(data_dir)
    t0 = time.perf_counter()
    shards = read_csv(data_dir)
    read_s = time.perf_counter() - t0

    def build():
        stack = autograd.Lambda(
            lambda *cols: autograd.stack(list(cols), axis=1))
        return _fraud_net(head=[stack]).compile("adam",
                                                "binary_crossentropy")
    net = build()
    net.set_tensorboard(os.path.join(root, "tb"), "fraud")
    kw = dict(feature_cols=feature_cols, label_cols=label_cols,
              batch_size=cfg["batch"])
    t0 = time.perf_counter()
    stats = net.fit(shards, nb_epoch=cfg["epochs"], verbose=False, **kw)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    summary = net.get_train_summary("Loss")
    steps = cfg["epochs"] * cfg["rows"] // cfg["batch"]
    pred = net.predict(shards, feature_cols=feature_cols,
                       batch_size=cfg["batch"])
    parts = pred.collect()
    loss = net.evaluate(shards, **kw)["loss"]
    path = os.path.join(root, "weights.pt")
    net.save_weights(path)
    again = build()
    again.load_weights(path)
    loss_again = again.evaluate(shards, **kw)["loss"]
    per = steps // cfg["epochs"]
    epoch_means = [float(np.mean([v for _, v in
                                  summary[e * per:(e + 1) * per]]))
                   for e in range(cfg["epochs"])]
    checks = {
        "partitions": shards.num_partitions() == cfg["files"],
        "summary_steps": [s for s, _ in summary] == list(range(1, steps + 1)),
        "summary_is_the_losses": np.allclose(
            epoch_means, [s["train_loss"] for s in stats], rtol=1e-6),
        "predict_xshards": len(parts) == cfg["files"] and all(
            p["prediction"].shape == (cfg["rows"] // cfg["files"], 1)
            and np.isfinite(p["prediction"]).all() for p in parts),
        "reload_same_loss": loss_again == loss and math.isfinite(loss),
        "on_card": _on_card(net.to_module())}
    emit({"phase": "keras_csv_fit", "rows": cfg["rows"],
          "files": cfg["files"], "batch": cfg["batch"],
          "epochs": cfg["epochs"], "read_s": read_s, "fit_s": fit_s,
          "fit_samples_per_s": cfg["rows"] * cfg["epochs"] / fit_s,
          "stats": stats, "summary_scalars": len(summary),
          "eval_loss": loss, "eval_loss_reloaded": loss_again,
          "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"Keras fit over read_csv XShards failed its checks: {checks}")


def _update_readings(run, ref, state):
    """The largest relative loss error over the steps, and the largest
    error of a step's parameter update relative to that parameter's
    largest update, over the entries whose sign rounding cannot decide:
    an entry whose CPU gradient is within TOL_FRAUD["grad"] of zero (of
    the largest entry) at a step is freed from then on, since a
    sign-like rule (Adamax's first step is mu / |g| = sign(g)) moves it
    by +-lr on the sign of a rounding error. Freed entries are counted,
    and their largest error is reported."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(run[0], ref[0]))
    worst, worst_freed, freed, prev_run, prev_ref = 0.0, 0.0, {}, state, \
        state
    for step in range(len(ref[0])):
        for k, g in ref[1][step].items():
            near0 = g.abs() <= TOL_FRAUD["grad"] * g.abs().max()
            free = freed.get(k, torch.zeros_like(near0)) | near0
            freed[k] = free
            d_run = run[2][step][k] - prev_run[k]
            d_ref = ref[2][step][k] - prev_ref[k]
            err = ((d_run - d_ref).abs()
                   / d_ref.abs().max().clamp_min(1e-30))
            if (~free).any():
                worst = max(worst, err[~free].max().item())
            if free.any():
                worst_freed = max(worst_freed, err[free].max().item())
        prev_run, prev_ref = run[2][step], ref[2][step]
    return {"loss": loss, "update": worst, "update_freed": worst_freed,
            "freed_entries": int(sum(f.sum().item()
                                     for f in freed.values()))}


def optimizers_vs_cpu_phase(card, dev="cuda"):
    """Each optax-formula optimizer, 3 steps of the fraud MLP at batch
    16384 on the card and on the CPU from the same weights (f32, TF32
    off): the losses and each step's parameter updates held to
    TOL_OPTIMIZERS (``_update_readings``), against the control of the
    card's steps with the first two batches swapped, which must miss
    both. Adamax runs at its default eps, 1e-38, an f32 subnormal:
    ``adamax_zero_grad`` reports what the card does where a gradient is 0
    (0 / 1e-38 = 0 keeps the parameter; a flush to zero would make it
    NaN)."""
    from analytics_zoo_tpu_torch.orca.learn.optimizers import (
        Adadelta, Adagrad, Adamax, Ftrl, RMSprop)
    optimizers = {
        "Adagrad": Adagrad(learningrate=0.01, learningrate_decay=0.01,
                           weightdecay=1e-4),
        "Adadelta": Adadelta(), "Adamax": Adamax(),
        "RMSprop": RMSprop(lr=1e-3),
        "Ftrl": Ftrl(learningrate=0.01, l2_regularization_strength=1e-4)}
    state = {k: v.clone() for k, v in
             _fraud_net().to_module().state_dict().items()}
    batches = _fraud_batches(3, FRAUD["batch"], seed=13)
    swapped = [batches[1], batches[0], batches[2]]
    t0 = time.perf_counter()
    result, failed = {}, []
    for name, opt in optimizers.items():
        card_run = _fraud_steps(dev, state, batches, opt.to_torch())
        cpu_run = _fraud_steps("cpu", state, batches, opt.to_torch())
        control_run = _fraud_steps(dev, state, swapped, opt.to_torch())
        got = _update_readings(card_run, cpu_run, state)
        control = _update_readings(control_run, cpu_run, state)
        ok = (all(got[k] <= TOL_OPTIMIZERS[k] for k in TOL_OPTIMIZERS)
              and all(control[k] > TOL_OPTIMIZERS[k]
                      for k in TOL_OPTIMIZERS)
              and all(math.isfinite(v) for v in card_run[0]))
        result[name] = {"loss_card": card_run[0], "loss_cpu": cpu_run[0],
                        "readings": got, "control_readings": control,
                        "ok": ok}
        if not ok:
            failed.append(name)
    # Adamax at eps 1e-38 where a gradient entry is exactly 0
    p = torch.nn.Parameter(torch.ones(4, device=dev))
    adamax = Adamax().to_torch()([p])
    p.grad = torch.tensor([0.0, 1.0, -2.0, 0.5], device=dev)
    adamax.step()
    zero = p.detach().cpu().tolist()
    result["adamax_zero_grad"] = {
        "params_after": zero, "eps_f32": float(np.float32(1e-38)),
        "zero_entry_kept": zero[0] == 1.0 and math.isfinite(zero[0])}
    emit({"phase": "optimizers_vs_cpu", "batch": FRAUD["batch"],
          "steps": 3, "limits": TOL_OPTIMIZERS,
          "control": "the card with the first two batches swapped",
          **result, "run_s": time.perf_counter() - t0, "card": card})
    if failed or not result["adamax_zero_grad"]["zero_entry_kept"]:
        fail(f"optimizers on the card disagree with the CPU: {failed}")


# --- Zouwu AutoTS (BASELINE #4) ----------------------------------------------

def _autots_frame():
    """bench_autots_trials's series: AUTOTS["points"] hourly points of
    sin(2 pi t / 24) + 0.1 N(0, 1) from numpy's RandomState(0)."""
    import pandas as pd
    n = AUTOTS["points"]
    rng = np.random.RandomState(0)
    value = (np.sin(np.arange(n) / 24 * 2 * np.pi)
             + 0.1 * rng.randn(n)).astype(np.float32)
    return pd.DataFrame({"datetime": pd.date_range("2024-01-01", periods=n,
                                                   freq="h"),
                         "value": value})


def _autots_recipes():
    from analytics_zoo_tpu_torch.zouwu.config.recipe import (
        LSTMGridRandomRecipe, TCNGridRandomRecipe)
    return [LSTMGridRandomRecipe(num_rand_samples=AUTOTS["n_rand"],
                                 epochs=AUTOTS["epochs"]),
            TCNGridRandomRecipe(num_rand_samples=AUTOTS["n_rand"],
                                training_iteration=AUTOTS["epochs"])]


def _seed_configs(recipe):
    """The trials the engine's seed gives a recipe: grid axes expanded,
    the rest sampled num_samples times from RandomState(seed), in the
    engine's order (TPUSearchEngine.compile)."""
    from analytics_zoo_tpu_torch.automl import hp
    space = recipe.search_space([])
    rng = np.random.RandomState(AUTOTS["engine_seed"])
    return [hp.sample_config(g, rng) for g in hp.grid_configs(space)
            for _ in range(recipe.num_samples)]


def autots_trials_phase(card, root):
    """bench_autots_trials at full size through ``AutoTSTrainer.fit`` on
    the card: one warm-up round, then AUTOTS["rounds"] timed rounds, each
    an LSTM and a TCN grid-random search of 4 trials (TPUSearchEngine,
    seed 42, the default scheduler: one trial at a time on the leased
    card). Every trial of every round must end ``done`` on cuda:0 with the
    config the seed gives. Then each recipe's winning ``TSPipeline``
    predicts (finite, one row a window) and evaluates (MSE below the mean
    predictor's), saves and loads, and the loaded pipeline evaluates to
    the same MSE."""
    from analytics_zoo_tpu_torch.zouwu.autots import (AutoTSTrainer,
                                                      TSPipeline)
    df = _autots_frame()
    recipes = _autots_recipes()
    expected = [_seed_configs(r) for r in recipes]
    trainer = AutoTSTrainer(dt_col="datetime", target_col="value",
                            horizon=AUTOTS["horizon"])
    t0 = time.perf_counter()
    for recipe in recipes:
        trainer.fit(df, validation_df=None, recipe=recipe)
    warmup_s = time.perf_counter() - t0
    round_s, bad, last = [], [], []
    for r in range(AUTOTS["rounds"]):
        t0 = time.perf_counter()
        pipes, rows = [], []
        for recipe, want in zip(recipes, expected):
            pipe = trainer.fit(df, validation_df=None, recipe=recipe)
            trials = trainer.engine._trials
            for t in trials:
                rows.append({"model": recipe.model_type(),
                             "trial": t.trial_id,
                             "config": t.config,
                             "score_mse": t.metric_value, "state": t.state,
                             "device": t.device,
                             "epochs": t.epochs_trained,
                             "seconds": t.duration_s})
            if ([t.config for t in trials] != want
                    or any(t.state != "done" or t.device != "cuda:0"
                           for t in trials)):
                bad.append((r, recipe.model_type()))
            pipes.append((recipe.model_type(), pipe,
                          trainer.engine.summary()))
        round_s.append(time.perf_counter() - t0)
        last = (pipes, rows)
    pipes, rows = last
    n_trials = len(rows)
    best = min(round_s)
    winners, checks = {}, {"all_trials_done_on_cuda0_with_seed_configs":
                           not bad and n_trials == 8}
    for model, pipe, summary in pipes:
        frame = pipe.predict(df)
        x, y = pipe.tsft.transform(df, is_train=True)
        res = pipe.evaluate(df, metrics=["mse", "smape"])
        path = os.path.join(root, f"{model}.pipeline")
        pipe.save(path)
        loaded = TSPipeline.load(path)
        again = loaded.evaluate(df, metrics=["mse", "smape"])
        mean_predictor = float(np.mean(y[:, :1] ** 2))
        winners[model] = {
            "config": pipe.config, "eval": res,
            "eval_loaded": again, "mean_predictor_mse": mean_predictor,
            "predict_rows": len(frame), "lease_telemetry": summary}
        checks[f"{model}_predict"] = (
            len(frame) == len(x) and list(frame.columns) == ["datetime",
                                                             "value"]
            and np.isfinite(frame["value"].to_numpy()).all())
        checks[f"{model}_beats_mean"] = res["mse"] < mean_predictor
        checks[f"{model}_reload_same_mse"] = again["mse"] == res["mse"]
        checks[f"{model}_on_card"] = all(
            p.is_cuda for p in loaded.forecaster.module.parameters())
    checks = {k: bool(v) for k, v in checks.items()}
    emit({"phase": "autots_trials", "points": AUTOTS["points"],
          "recipes": [f"LSTMGridRandomRecipe(num_rand_samples="
                      f"{AUTOTS['n_rand']}, epochs={AUTOTS['epochs']})",
                      f"TCNGridRandomRecipe(num_rand_samples="
                      f"{AUTOTS['n_rand']}, training_iteration="
                      f"{AUTOTS['epochs']})"],
          "engine": "TPUSearchEngine(seed=42), default scheduler",
          "trials_per_round": n_trials, "warmup_round_s": warmup_s,
          "round_s": round_s, "best_round_s": best,
          "trials_per_hour": n_trials / best * 3600.0,
          "trials_per_hour_mean_round": n_trials / statistics.mean(round_s)
          * 3600.0, "trials_last_round": rows, "winners": winners,
          "rounds_off_seed_or_not_done": bad, "checks": checks,
          "card": card})
    if not all(checks.values()):
        fail(f"AutoTS on the card failed its checks: {checks}, {bad}")
    return df, rows


def _zouwu_classes(name, ops):
    """The class of a device event of a forecaster step: the copies, Adam,
    cuDNN's RNN kernels, the convs, the GEMMs, else elementwise."""
    if "dtod" in name:
        return "d2d_copy"
    if _is_copy(name):
        return "h2d_copy"
    ops_s = " ".join(ops).lower()
    if "optimizer.step" in ops_s:
        return "adam"
    side = "backward" if "backward" in ops_s else "forward"
    if "rnn" in ops_s or "lstm" in ops_s:
        return f"cudnn_rnn_{side}"
    if "convolution" in ops_s:
        return f"conv_{side}"
    if "gemm" in name or "cutlass" in name or "xmma" in name:
        return f"gemm_{side}"
    return f"elementwise_{side}"


def zouwu_step_flops(module, x):
    """A training step's matmul FLOPs (2 a multiply-add), from the shapes
    one forward over the batch ``x`` meets: the forward, and its weight
    and input gradients at the forward's count each (an upper count: the
    first layer's input gradient is not needed). An LSTM cell does
    4h (in + h) multiply-adds a row and step; a causal conv K Cin Cout a
    row and kept step."""
    from analytics_zoo_tpu_torch.zouwu.model import nets
    counted = []

    def hook(m, args, out):
        a = args[0]
        if isinstance(m, nets.OptimizedLSTMCell):
            n_in = m.ii.in_features
            counted.append(2.0 * a.shape[0] * a.shape[1] * 4 * m.features
                           * (n_in + m.features))
        elif isinstance(m, torch.nn.Conv1d):
            counted.append(2.0 * a.shape[0] * a.shape[-1] * m.kernel_size[0]
                           * m.in_channels * m.out_channels)
        else:
            counted.append(2.0 * a.numel() / m.in_features * m.in_features
                           * m.out_features)
    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (nets.OptimizedLSTMCell, torch.nn.Conv1d,
                                 torch.nn.Linear))]
    try:
        with torch.no_grad():
            module(x)
    finally:
        for h in handles:
            h.remove()
    fwd = sum(counted)
    return {"forward_flops": fwd, "step_flops": 3.0 * fwd,
            "parameters": sum(p.numel() for p in module.parameters())}


def autots_profile_phase(card, df, rows):
    """torch.profiler over AUTOTS_PROFILE_STEPS steps of one LSTM trial
    and one TCN trial at batch 64 (the first batch-64 config of each
    search), fed through the infeed pump after a warm epoch: device ms a
    step by class, kernels a step, idle share, and the step's FLOPs
    against the f32 peak."""
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.orca.learn import utils as learn_utils
    from analytics_zoo_tpu_torch.zouwu.autots import AutoTSTrainer
    from analytics_zoo_tpu_torch.zouwu.config.recipe import \
        convert_bayes_config
    from analytics_zoo_tpu_torch.zouwu.feature.time_sequence import \
        TimeSequenceFeatureTransformer
    trainer = AutoTSTrainer(horizon=AUTOTS["horizon"])
    out = {}
    n = AUTOTS_PROFILE_STEPS
    for model in ("LSTM", "TCN"):
        cfg = next(r["config"] for r in rows
                   if r["model"] == model and r["config"]["batch_size"] == 64)
        cfg = convert_bayes_config(cfg)
        tsft = TimeSequenceFeatureTransformer(horizon=AUTOTS["horizon"])
        x, y = tsft.fit_transform(df, past_seq_len=int(cfg["past_seq_len"]))
        target = y[:, 0:1] if model == "LSTM" else y[..., None]
        f = trainer._build_forecaster(model, cfg, tsft.feature_num, None)
        f.fit(x, target, epochs=1, batch_size=64)
        t0 = time.perf_counter()
        stats = f.fit(x, target, epochs=1, batch_size=64, profile=True)[0]
        epoch_s = time.perf_counter() - t0
        eng = f.estimator.engine
        it = learn_utils.BatchIterator({"x": (x,), "y": (target,)}, 64,
                                       shuffle=True, device=f.device)
        batches = it.epoch(prefetch=True)
        try:
            eng.train_batch(next(batches))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    eng.train_batch(next(batches))
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            batches.close()
        dev_events = _device_events(prof)
        if not dev_events:
            fail(f"the profiler saw no device time in the {model} steps")
        stacks = _launching_ops(prof)
        by_class, by_kernel = {}, {}
        for evt in dev_events:
            ms = evt.time_range.elapsed_us() / 1e3 / n
            cls = _zouwu_classes(evt.name.lower(), stacks.get(evt.id) or [])
            by_class[cls] = by_class.get(cls, 0.0) + ms
            tot, k = by_kernel.get(evt.name, (0.0, 0))
            by_kernel[evt.name] = (tot + ms, k + 1)
        busy = _busy_ms(dev_events) / n
        flops = zouwu_step_flops(f.module, torch.from_numpy(x[:64]).to(
            f.device))
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
        out[model] = {
            "config": cfg,
            "unprofiled_epoch": {
                "steps": stats["profile"]["steps"], "fit_s": epoch_s,
                "step_ms_median": statistics.median(
                    stats["profile"]["step_ms"]),
                "timing": "CUDA events around each step of a fit epoch, "
                          "no profiler"},
            "wall_ms_per_step": wall_ms / n,
            "device_busy_ms_per_step": busy,
            "device_idle_share": 1.0 - busy * n / wall_ms,
            "kernels_per_step": len(dev_events) / n,
            "device_ms_by_class_per_step": by_class,
            "top_kernels_ms_per_step": [
                {"name": k[:160], "ms": v[0], "launches": v[1] / n}
                for k, v in top],
            **flops, "bound_ms": flops["step_flops"] / PEAK_F32_CUDA_CORES
            * 1e3,
            "busy_fp32_share": flops["step_flops"] / (busy / 1e3)
            / PEAK_F32_CUDA_CORES}
    emit({"phase": "autots_profile", "batch": 64, "steps_profiled": n,
          "fp32_peak_flops": PEAK_F32_CUDA_CORES, **out, "card": card})


def _zouwu_forecasters(dev):
    """The four forecasters at the AutoTS path's widths (6 features, past
    50, horizon 1), dropout off, nets drawn from seed 0."""
    from analytics_zoo_tpu_torch.zouwu.model import forecast as F
    nets = {
        "LSTM": ("LSTMNet", dict(input_dim=6, lstm_units=(32, 16),
                                 dropouts=(0.0, 0.0))),
        "TCN": ("TCNNet", dict(past_seq_len=50, future_seq_len=1,
                               input_dim=6, num_channels=(16, 16, 16),
                               kernel_size=3, dropout=0.0)),
        "Seq2Seq": ("Seq2SeqNet", dict(input_dim=6, future_seq_len=1,
                                       latent_dim=64)),
        "MTNet": ("MTNetLite", dict(input_dim=6, ar_window=4, cnn_kernel=3,
                                    cnn_channels=32, dropout=0.0))}
    return {k: F.Forecaster.from_spec(spec, device=dev, lr=1e-3,
                                      loss="mae" if k == "MTNet" else "mse")
            for k, spec in nets.items()}


def _zouwu_steps(dev, name, batches):
    """Two Adam steps of forecaster ``name`` on ``dev``: each step's loss
    and gradients, on the CPU."""
    from analytics_zoo_tpu_torch.orca.learn.utils import Batch
    f = _zouwu_forecasters(dev)[name]
    eng = f.estimator.engine
    eng.build()
    losses, grads = [], []
    for bx, by in batches:
        losses.append(float(eng.train_batch(Batch(x=(bx,), y=(by,),
                                                  w=None))))
        grads.append({n: p.grad.detach().cpu().clone()
                      for n, p in f.module.named_parameters()})
    return losses, grads


def _floored_rel(got, want):
    """The largest error of a gradient relative to its largest entry,
    floored at 1e-3 of the largest gradient of the step (MTNetLite's
    attention bias has a zero gradient in exact arithmetic)."""
    floor = 1e-3 * max(g.abs().max().item() for g in want.values())
    return max((got[k] - want[k]).abs().max().item()
               / max(want[k].abs().max().item(), floor) for k in want)


def zouwu_vs_cpu_phase(card, df):
    """Two Adam steps of each forecaster (LSTM, TCN, Seq2Seq, MTNet) at
    batch 64 on the AutoTS windows, on the card and on the CPU from the
    same weights (seed 0), dropout off, f32 with TF32 off (matmuls and
    cuDNN, so cuDNN's LSTM runs in f32): losses and gradients held to
    TOL_ZOUWU, against the control of the card's steps with the two
    batches swapped, which must miss both."""
    from analytics_zoo_tpu_torch.zouwu.feature.time_sequence import \
        TimeSequenceFeatureTransformer
    x, y = TimeSequenceFeatureTransformer(horizon=1).fit_transform(
        df, past_seq_len=50)
    rng = np.random.RandomState(17)
    rows = [rng.choice(len(x), 64, replace=False) for _ in range(2)]
    result, failed = {}, []
    t0 = time.perf_counter()
    for name in ("LSTM", "TCN", "Seq2Seq", "MTNet"):
        target = y[:, :1] if name in ("LSTM", "MTNet") else y[..., None]
        batches = [(x[r], target[r]) for r in rows]
        card_run = _zouwu_steps("cuda", name, batches)
        cpu_run = _zouwu_steps("cpu", name, batches)
        control_run = _zouwu_steps("cuda", name, batches[::-1])

        def readings(run):
            return {"loss": max(abs(a - b) / abs(b) for a, b in
                                zip(run[0], cpu_run[0])),
                    "grad": max(_floored_rel(g, w) for g, w in
                                zip(run[1], cpu_run[1]))}
        got, control = readings(card_run), readings(control_run)
        ok = (all(got[k] <= TOL_ZOUWU[k] for k in TOL_ZOUWU)
              and all(control[k] > TOL_ZOUWU[k] for k in TOL_ZOUWU)
              and all(map(math.isfinite, card_run[0])))
        result[name] = {"loss_card": card_run[0], "loss_cpu": cpu_run[0],
                        "readings": got, "control_readings": control,
                        "ok": ok}
        if not ok:
            failed.append(name)
    emit({"phase": "zouwu_vs_cpu", "batch": 64, "steps": 2,
          "limits": TOL_ZOUWU,
          "cudnn": {"enabled": torch.backends.cudnn.enabled,
                    "allow_tf32": torch.backends.cudnn.allow_tf32,
                    "version": torch.backends.cudnn.version()},
          "control": "the card with the two batches swapped", **result,
          "run_s": time.perf_counter() - t0, "card": card})
    if failed:
        fail(f"forecaster steps on the card disagree with the CPU: {failed}")


def zouwu_real_data_phase(card):
    """tests/test_zouwu_real_data.py::test_mtnet_lite_on_nyc_taxi's gate on
    the card, over the NAB NYC-taxi subset in the repository: windows of
    48 half-hours -> the next; MTNetForecaster(ar 8, cnn height 6, lr
    5e-3) 60 epochs at batch 256 must beat persistence and the
    day-seasonal naive on the 932 held-out windows; LSTMForecaster(lr
    5e-3) 30 epochs, and MTNetLite's MSE must stay under 1.3 x the LSTM's
    + 1e-3. Each of the REAL_DATA_SEEDS initial draws (the nets' init
    seed) is held to the whole gate; the medians are reported."""
    import pandas as pd

    from analytics_zoo_tpu_torch.zouwu.model import forecast as F
    here = os.path.dirname(os.path.abspath(__file__))
    v = pd.read_csv(os.path.join(here, "tests", "resources",
                                 "nyc_taxi_subset.csv"))["value"].to_numpy(
        np.float32)
    series = (v - v.mean()) / v.std()
    past, n_train = 48, 3000
    x = np.stack([series[i:i + past]
                  for i in range(len(series) - past - 1)])[..., None]
    y = np.stack([series[i + past:i + past + 1]
                  for i in range(len(series) - past - 1)])
    truth = y[n_train:].reshape(-1)
    persistence = float(np.mean((x[n_train:, -1, 0] - truth) ** 2))
    seasonal = float(np.mean((x[n_train:, -48, 0] - truth) ** 2))
    draws = []
    t0 = time.perf_counter()
    for seed in REAL_DATA_SEEDS:
        def build(spec):
            return F.build_net(spec, seed)
        mt = F.Forecaster(build(("MTNetLite", dict(
            input_dim=1, ar_window=8, cnn_kernel=6, cnn_channels=32))),
            loss="mae", lr=5e-3)
        mt.fit(x[:n_train], y[:n_train], epochs=60, batch_size=256)
        lstm = F.Forecaster(build(("LSTMNet", dict(
            input_dim=1, lstm_units=(16, 8), dropouts=(0.2, 0.2)))),
            loss="mse", lr=5e-3)
        lstm.fit(x[:n_train], y[:n_train], epochs=30, batch_size=256)
        draws.append({
            "seed": seed,
            "mtnet_mse": float(np.mean(
                (mt.predict(x[n_train:]).reshape(-1) - truth) ** 2)),
            "lstm_mse": float(np.mean(
                (lstm.predict(x[n_train:]).reshape(-1) - truth) ** 2))})
    mt_med = statistics.median(d["mtnet_mse"] for d in draws)
    lstm_med = statistics.median(d["lstm_mse"] for d in draws)
    checks = {
        "every_mtnet_beats_persistence": all(
            d["mtnet_mse"] < persistence for d in draws),
        "every_mtnet_beats_seasonal": all(
            d["mtnet_mse"] < seasonal for d in draws),
        "every_mtnet_within_lstm_band": all(
            d["mtnet_mse"] < 1.3 * d["lstm_mse"] + 1e-3 for d in draws),
        "finite": all(math.isfinite(d["mtnet_mse"])
                      and math.isfinite(d["lstm_mse"]) for d in draws)}
    emit({"phase": "zouwu_real_data", "series": "nyc_taxi_subset.csv",
          "windows_train": n_train, "windows_test": len(truth),
          "persistence_mse": persistence, "seasonal_mse": seasonal,
          "draws": draws, "mtnet_median_mse": mt_med,
          "lstm_median_mse": lstm_med,
          "band": "mtnet < 1.3 * lstm + 1e-3", "checks": checks,
          "run_s": time.perf_counter() - t0, "card": card})
    if not all(checks.values()):
        fail(f"the NYC-taxi gate failed on the card: {checks}")


def auto_estimator_search_phase(card):
    """``AutoEstimator.from_torch`` over a small torch MLP on the card: lr
    (grid of 2) x batch size (choice of 2), 2 samples each, 8 epochs of
    4,096 rows of a noisy linear target; every trial ``done`` on cuda:0;
    ``get_best_model().evaluate`` on the validation rows equals the best
    trial's score exactly, and beats the mean predictor."""
    from analytics_zoo_tpu_torch.automl import AutoEstimator, hp
    rng = np.random.RandomState(21)
    w = rng.randn(16).astype(np.float32)

    def rows(n):
        x = rng.randn(n, 16).astype(np.float32)
        y = (x @ w + 0.1 * rng.randn(n)).astype(np.float32)[:, None]
        return {"x": x, "y": y}
    data, val = rows(4096), rows(1024)

    def creator(config):
        torch.manual_seed(0)
        return torch.nn.Sequential(
            torch.nn.Linear(16, config["hidden"]), torch.nn.ReLU(),
            torch.nn.Linear(config["hidden"], 1))
    auto = AutoEstimator.from_torch(model_creator=creator,
                                    loss=torch.nn.MSELoss(),
                                    optimizer="adam")
    t0 = time.perf_counter()
    auto.fit(data, epochs=8, validation_data=val, metric="mse",
             n_sampling=2, search_space={
                 "lr": hp.grid_search([1e-2, 1e-4]),
                 "hidden": hp.choice([32, 64]),
                 "batch_size": hp.choice([64, 128])})
    fit_s = time.perf_counter() - t0
    trials = auto.get_trials()
    best = auto.best_trial
    est = auto.get_best_model()
    res = est.evaluate(val, batch_size=best.config["batch_size"],
                       verbose=False)
    mean_mse = float(np.mean((val["y"] - data["y"].mean()) ** 2))
    checks = {
        "all_done_on_cuda0": len(trials) == 4 and all(
            t.state == "done" and t.device == "cuda:0" for t in trials),
        "best_model_evaluates_to_best_score": res["mse"] == best.metric_value,
        "beats_mean_predictor": res["mse"] < mean_mse,
        "on_card": _on_card(est.module)}
    emit({"phase": "auto_estimator_search", "fit_s": fit_s,
          "trials": [{"config": t.config, "mse": t.metric_value,
                      "state": t.state, "device": t.device,
                      "seconds": t.duration_s} for t in trials],
          "best_config": auto.get_best_config(),
          "best_eval": res, "mean_predictor_mse": mean_mse,
          "summary": auto.search_summary(), "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"AutoEstimator search on the card failed its checks: {checks}")


# --- the ASHA TrialRuntime, the estimator's preemption plane, AutoXGBoost ----

def _study_events(logs_dir):
    with open(os.path.join(logs_dir, "study_events.jsonl")) as f:
        return [json.loads(line) for line in f]


def asha_autots_phase(card, df, dev="cuda"):
    """Each AutoTS recipe at ASHA_AUTOTS through ``AutoTSTrainer.fit(...,
    scheduler="asha")`` on the card, then the same recipe and seed under
    the default scheduler (the exhaustive search). Every ASHA trial ends
    ``done`` on the leased device with the config the engine's seed gives;
    fewer than half the exhaustive epochs are trained and the rung
    populations shrink; the winner trained the whole budget and scores
    within ASHA_WINNER_FACTOR of the exhaustive best; the study's event
    log has a start and an end for every trial (``trial_done``, or
    ``trial_pruned`` for a trial the study ended paused) and its manifest
    ends ``completed``."""
    from analytics_zoo_tpu_torch.zouwu.autots import AutoTSTrainer
    from analytics_zoo_tpu_torch.zouwu.config.recipe import (
        LSTMGridRandomRecipe, TCNGridRandomRecipe)
    cfg = ASHA_AUTOTS
    leased = "cuda:0" if dev == "cuda" else "cpu"
    recipes = [LSTMGridRandomRecipe(num_rand_samples=cfg["n_rand"],
                                    epochs=cfg["epochs"]),
               TCNGridRandomRecipe(num_rand_samples=cfg["n_rand"],
                                   training_iteration=cfg["epochs"])]
    params = {"eta": cfg["eta"], "grace_period": cfg["grace_period"]}
    root = tempfile.mkdtemp(prefix="asha-autots-")
    results, checks = {}, {}
    try:
        for recipe in recipes:
            model = recipe.model_type()
            logs = os.path.join(root, model)
            runs = {}
            for scheduler in ("asha", None):
                trainer = AutoTSTrainer(
                    dt_col="datetime", target_col="value",
                    horizon=AUTOTS["horizon"], scheduler=scheduler,
                    scheduler_params=params,
                    logs_dir=logs if scheduler else None, device=dev)
                t0 = time.perf_counter()
                pipe = trainer.fit(df, validation_df=None, recipe=recipe)
                wall = time.perf_counter() - t0
                runs[scheduler] = (trainer.engine, pipe, wall)
            eng, pipe, wall = runs["asha"]
            full, _, full_wall = runs[None]
            trials, s = eng._trials, eng.summary()
            n = len(trials)
            best, full_best = eng.get_best_trial(), full.get_best_trial()
            reported = [r["reported"] for r in s["rungs"]]
            events = _study_events(logs)
            started = {e["trial"] for e in events
                       if e["event"] == "trial_start"}
            ended = {e["trial"]: e["event"] for e in events
                     if e["event"] in ("trial_done", "trial_pruned")}
            with open(os.path.join(logs, "study_state.json")) as f:
                manifest = json.load(f)
            ids = {t.trial_id for t in trials}
            res = pipe.evaluate(df, metrics=["mse"])
            checks.update({
                f"{model}_done_on_{leased}_with_seed_configs": (
                    n == 2 * cfg["n_rand"]
                    and [t.config for t in trials] == _seed_configs(recipe)
                    and all(t.state == "done" and t.device == leased
                            for t in trials)),
                f"{model}_under_half_the_exhaustive_epochs": (
                    s["epochs"]["trained"] < 0.5 * n * cfg["epochs"]
                    and s["epochs"]["exhaustive"] == n * cfg["epochs"]),
                f"{model}_rungs_shrink": (
                    s["rungs"][-1]["budget_epochs"] == cfg["epochs"]
                    and reported[0] == n
                    and reported[0] > reported[1] >= reported[2] >= 1),
                f"{model}_winner_trained_max_t":
                    best.epochs_trained == cfg["epochs"],
                f"{model}_winner_within_factor_of_exhaustive":
                    best.metric_value <= ASHA_WINNER_FACTOR
                    * full_best.metric_value,
                f"{model}_events_start_and_end_every_trial":
                    started == ids and set(ended) == ids,
                f"{model}_manifest_completed":
                    manifest["status"] == s["status"] == "completed",
                f"{model}_pipeline_evaluates": math.isfinite(res["mse"])})
            results[model] = {
                "trials": n, "asha_wall_s": wall,
                "exhaustive_wall_s": full_wall,
                "asha_trials_per_hour": n / wall * 3600.0,
                "exhaustive_trials_per_hour": n / full_wall * 3600.0,
                "epochs_trained": s["epochs"]["trained"],
                "epochs_exhaustive": s["epochs"]["exhaustive"],
                "exhaustive_epochs_trained": full.summary()["epochs"][
                    "trained"],
                "rungs": s["rungs"], "counters": s["counters"],
                "winner": {"config": best.config, "mse": best.metric_value,
                           "epochs": best.epochs_trained},
                "exhaustive_best": {"config": full_best.config,
                                    "mse": full_best.metric_value},
                "winner_over_exhaustive_best": best.metric_value
                / full_best.metric_value,
                "utilization": s["chips"]["utilization"],
                "lease_busy_s": s["chips"]["busy_s"],
                "trial_end_events": {e: list(ended.values()).count(e)
                                     for e in ("trial_done",
                                               "trial_pruned")},
                # AutoTS's state holds a live forecaster, which the
                # checkpoint plane's skeleton pickle refuses: RAM fallback
                "trial_ckpt_saves": s["ckpt"].get("saves", 0),
                "pipeline_mse": res["mse"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    checks = {k: bool(v) for k, v in checks.items()}
    emit({"phase": "asha_autots", "points": AUTOTS["points"],
          "scheduler_params": params, "max_t": cfg["epochs"],
          "limit": {"epochs": "< 0.5 x exhaustive", "winner_mse":
                    f"<= {ASHA_WINNER_FACTOR} x exhaustive best"},
          "control": "the exhaustive search (scheduler=None), same seed",
          "results": results, "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"ASHA AutoTS on the card failed its checks: {checks}")


def _resume_data(seed):
    cfg = ASHA_RESUME
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(31).randn(cfg["features"]).astype(np.float32)
    x = rng.randn(cfg["rows"], cfg["features"]).astype(np.float32)
    y = (x @ w + 0.1 * rng.randn(cfg["rows"])).astype(np.float32)
    return {"x": x, "y": y[:, None]}


def _resume_creator(config):
    """The MLP of the resume checks: its dropout draws from the training
    engine's generator, reseeded from the step, so a resumed run draws
    the masks an uninterrupted one does."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.self_attention \
        import Dropout
    cfg = ASHA_RESUME
    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Linear(cfg["features"], cfg["hidden"]), torch.nn.ReLU(),
        Dropout(0.1), torch.nn.Linear(cfg["hidden"], 1))


def _same_params(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


class _SigtermAtContinue:
    """Wraps trials' ``TrialContext``: counts their reports, and at the
    first one from ``at`` on that lets its trial train on ("continue"),
    sends this process SIGTERM and waits until the study halts, so that
    trial is preempted at its next heartbeat (a deterministic point; the
    runtime's watcher latches the signal on the main thread)."""

    def __init__(self, at=1):
        self.at, self.count, self.fired_at = at, 0, None

    def wrap(self, ctx):
        hook = self

        class _Ctx:
            def __getattr__(self, name):
                return getattr(ctx, name)

            def report(self, step, metric):
                hook.count += 1
                out = ctx.report(step, metric)
                if hook.fired_at is None and hook.count >= hook.at \
                        and out == "continue":
                    hook.fired_at = (ctx.trial_id, int(step), hook.count)
                    os.kill(os.getpid(), signal.SIGTERM)
                    if not ctx._runtime._halt.wait(30):
                        fail("the study did not halt on SIGTERM")
                return out
        return _Ctx()


def _hooked_builder(builder, hook):
    """``builder`` whose trial models report through ``hook``."""
    from analytics_zoo_tpu_torch.automl import ModelBuilder

    class Hooked(ModelBuilder):
        def __call__(self, config, device):
            tm = super().__call__(config, device)
            fit_eval = tm.fit_eval

            def hooked(data, validation_data=None, epochs=1, metric="mse",
                       state=None, trial_context=None):
                return fit_eval(data, validation_data, epochs, metric,
                                state=state,
                                trial_context=hook.wrap(trial_context))
            tm.fit_eval = hooked
            return tm
    return Hooked(builder.model_creator, builder.optimizer_creator,
                  builder.loss_creator)


def asha_resume_phase(card, dev="cuda"):
    """The JAX suite's "resumed trials are bit-identical to uninterrupted
    ones" on the card. Pause/resume: two straight 4-epoch runs of a
    ``TrialModel`` (read: do they agree?), then 2 epochs, a checkpoint
    through the checkpoint plane to disk and back, and 2 more in a fresh
    model: every parameter and the step equal the straight run's; the
    control resumes with the shuffle's epoch off by one and must differ.
    SIGTERM: an ASHA study through ``AutoEstimator.fit`` with a
    ``logs_dir`` is sent SIGTERM from a report hook; ``fit`` returns with
    the study ``preempted`` and the running trial checkpointed; a fresh
    ``AutoEstimator`` on the same ``logs_dir`` adopts the manifest, and its
    rung ledger and winner (config, epochs, score) equal an uninterrupted
    study's on one lease."""
    from analytics_zoo_tpu_torch.automl import AutoEstimator, ModelBuilder, hp
    from analytics_zoo_tpu_torch.ckpt import (CheckpointPlane,
                                              load_checkpoint_dir)
    cfg = ASHA_RESUME
    data, val = _resume_data(0), _resume_data(1)
    device = torch.device(dev, 0) if dev == "cuda" else torch.device(dev)
    leased = str(device)
    builder = ModelBuilder(_resume_creator,
                           loss_creator=lambda c: torch.nn.MSELoss())
    trial_cfg = {"lr": 1e-3, "batch_size": cfg["batch"]}
    t0 = time.perf_counter()
    straight = [builder(trial_cfg, device).fit_eval(
        data, val, epochs=cfg["epochs"], metric="mse") for _ in range(2)]
    first = builder(trial_cfg, device)
    _, _, paused = first.fit_eval(data, val, epochs=cfg["pause_at"],
                                  metric="mse")
    root = tempfile.mkdtemp(prefix="asha-resume-")
    try:
        plane = CheckpointPlane(os.path.join(root, "ckpt"), keep_last_k=2)
        path = plane.save(paused, cfg["pause_at"], name="trial_0",
                          blocking=True)
        plane.close()
        from_disk = load_checkpoint_dir(path)
        resumed = builder(trial_cfg, device)
        score_r, _, state_r = resumed.fit_eval(
            data, val, epochs=cfg["epochs"], metric="mse", state=from_disk)
        control = builder(trial_cfg, device)
        control.fit_eval(data, val, epochs=0, metric="mse", state=from_disk)
        control.estimator.fit(data, epochs=cfg["epochs"] - cfg["pause_at"],
                              batch_size=cfg["batch"], verbose=False,
                              initial_epoch=cfg["pause_at"] + 1)
        state_c = control.estimator.engine.get_state()
        (score_a, _, state_a), (score_b, _, state_b) = straight
        pause_s = time.perf_counter() - t0

        def study(logs, hook=None):
            auto = AutoEstimator.from_torch(
                model_creator=_resume_creator, loss=torch.nn.MSELoss(),
                optimizer="adam", logs_dir=logs, device=dev)
            if hook is not None:
                auto.model_builder = _hooked_builder(auto.model_builder, hook)
            auto.fit(data, epochs=cfg["max_t"], validation_data=val,
                     metric="mse", n_sampling=cfg["n_sampling"],
                     search_space={"lr": hp.loguniform(1e-4, 1e-1),
                                   "batch_size": hp.grid_search([64, 128])},
                     scheduler="asha",
                     scheduler_params={"eta": cfg["eta"],
                                       "grace_period": 1})
            return auto

        t1 = time.perf_counter()
        ref = study(os.path.join(root, "straight"))
        ref_s = time.perf_counter() - t1
        logs = os.path.join(root, "preempted")
        hook = _SigtermAtContinue()
        t1 = time.perf_counter()
        cut = study(logs, hook)
        cut_s = time.perf_counter() - t1
        cut_summary = cut.searcher._runtime.summary()
        with open(os.path.join(logs, "study_state.json")) as f:
            manifest = json.load(f)
        inflight = [t for t in manifest["trials"]
                    if t["status"] == "paused" and t["runnable"]]
        t1 = time.perf_counter()
        again = study(logs)
        again_s = time.perf_counter() - t1
        events = _study_events(logs)
        s, want = again.search_summary(), ref.search_summary()
        a, b = again.best_trial, ref.best_trial
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_trials = 2 * cfg["n_sampling"]
    readings = {
        "straight_runs_agree": _same_params(state_a["params"],
                                            state_b["params"])
        and score_a == score_b,
        "straight_score": score_a, "resumed_score": score_r,
        "step": state_a["step"], "resumed_step": state_r["step"],
        "control_step": state_c["step"],
        "control_params_equal": _same_params(state_a["params"],
                                             state_c["params"]),
        "sigterm_at": hook.fired_at,
        "preempted_status": cut_summary["status"],
        "preempted_trials": cut_summary["trials"],
        "inflight_checkpointed": [(t["id"], t["epochs_done"])
                                  for t in inflight],
        "resumed_status": s["status"], "resumed_trials": s["trials"],
        "rungs": s["rungs"], "uninterrupted_rungs": want["rungs"],
        "winner": {"config": a.config, "epochs": a.epochs_trained,
                   "mse": a.metric_value},
        "uninterrupted_winner": {"config": b.config,
                                 "epochs": b.epochs_trained,
                                 "mse": b.metric_value}}
    checks = {
        "straight_runs_agree": readings["straight_runs_agree"],
        "resumed_equals_straight": (
            _same_params(state_a["params"], state_r["params"])
            and state_r["step"] == state_a["step"] and score_r == score_a),
        "control_differs": (state_c["step"] == state_a["step"]
                            and not readings["control_params_equal"]),
        "sigterm_fired_mid_study": hook.fired_at is not None,
        "interrupted_run_preempted": (
            cut_summary["status"] == manifest["status"] == "preempted"),
        "running_trial_checkpointed": (
            len(inflight) == 1 and inflight[0]["epochs_done"] > 0
            and inflight[0]["ckpt"] is not None),
        "manifest_adopted": any(e["event"] == "study_resume"
                                for e in events),
        "every_trial_accounted": (
            s["status"] == "completed"
            and s["trials"] == {"total": n_trials, "done": n_trials}
            and len(manifest["trials"]) == n_trials),
        "rung_ledger_equal": s["rungs"] == want["rungs"],
        "winner_equal": (a.config, a.epochs_trained, a.metric_value)
        == (b.config, b.epochs_trained, b.metric_value),
        # a trial the resumed run did not train keeps device None
        "on_card": all(t.device == leased for t in ref.get_trials())
        and all(t.device in (None, leased) for t in again.get_trials())}
    checks = {k: bool(v) for k, v in checks.items()}
    emit({"phase": "asha_resume", "config": cfg, "readings": readings,
          "limit": "bit for bit", "control": "shuffle epoch off by one",
          "pause_resume_s": pause_s, "uninterrupted_study_s": ref_s,
          "preempted_study_s": cut_s, "resumed_study_s": again_s,
          "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"ASHA resume on the card failed its checks: {checks}")


def estimator_preemption_phase(card, dev="cuda"):
    """The fraud MLP at BASELINE #3's widths through ``TPUEstimator.fit``
    with a ``model_dir``, SIGTERM from a trigger at iteration >= 10
    (tests/test_estimator.py's preemption test): ``fit`` returns early, the
    last epoch's stats carry ``preempted`` and ``partial_epoch``,
    ``ckpt-{step}`` exists, and a fresh estimator (other initial weights:
    the control) restores the stopped one's weights bit for bit."""
    from analytics_zoo_tpu_torch.orca.learn.estimator import TPUEstimator
    from analytics_zoo_tpu_torch.orca.learn.trigger import SeveralIteration
    cfg = FRAUD
    x, y = synthetic_fraud(cfg["rows"], cfg["features"], cfg["fraud_rate"],
                           cfg["seed"])
    data = {"x": x, "y": y[:, None]}

    class _SigtermAt(SeveralIteration):
        fired = None

        def __call__(self, state):
            if state.iteration >= 10 and self.fired is None:
                self.fired = state.iteration
                os.kill(os.getpid(), signal.SIGTERM)
            return False

    root = tempfile.mkdtemp(prefix="preempt-")
    try:
        est = TPUEstimator(_fraud_net(seed=0).to_module(),
                           loss="binary_crossentropy", optimizer="adam",
                           model_dir=root, device=dev)
        trigger = _SigtermAt(10_000)
        before = signal.getsignal(signal.SIGTERM)
        t0 = time.perf_counter()
        stats = est.fit(data, epochs=cfg["epochs"], batch_size=cfg["batch"],
                        checkpoint_trigger=trigger, verbose=False)
        fit_s = time.perf_counter() - t0
        step = est.engine.step
        ckpts = sorted(d for d in os.listdir(root) if d.startswith("ckpt-"))
        fresh = TPUEstimator(_fraud_net(seed=1).to_module(),
                             loss="binary_crossentropy", optimizer="adam",
                             device=dev)
        fresh.fit(data, epochs=0, batch_size=cfg["batch"], verbose=False)
        want = est.engine.get_state()
        control_equal = _same_params(fresh.engine.get_state()["params"],
                                     want["params"])
        fresh.load_checkpoint(root)
        got = fresh.engine.get_state()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    checks = {
        "returned_early": 0 < len(stats) < cfg["epochs"],
        "last_stats_preempted": (stats[-1].get("preempted") is True
                                 and stats[-1].get("partial_epoch") is True),
        "handler_restored": signal.getsignal(signal.SIGTERM) is before,
        "ckpt_at_stop_step": f"ckpt-{step}" in ckpts,
        "restored_bitwise": (_same_params(got["params"], want["params"])
                             and got["step"] == step),
        "control_differs": not control_equal,
        "on_card": _on_card(est.module) if dev == "cuda" else True}
    emit({"phase": "estimator_preemption", "widths": cfg["widths"],
          "batch": cfg["batch"], "sigterm_at_iteration": trigger.fired,
          "stopped_at_step": step, "epochs_returned": len(stats),
          "last_stats": stats[-1], "checkpoints": ckpts, "fit_s": fit_s,
          "limit": "bit for bit", "control": "a fresh estimator's own "
          "initial weights", "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"estimator preemption on the card failed its checks: {checks}")


def auto_xgb_phase(card, dev="cuda"):
    """``AutoXGBRegressor`` (XgbRegressorGridRandomRecipe) and
    ``AutoXGBClassifier`` through the engine on the card's lease: every
    trial ``done`` on the leased device. The trees are host numpy under
    either lease (the bundled histogram GBT, as xgboost is not installed),
    so a ``device="cpu"`` run must give the same best config and
    predictions bit for bit: a determinism check of the search, not a
    reference. Parity with the JAX package is held on the CPU by
    tests/test_torch_scheduler.py::test_auto_xgb_equals_jax."""
    from analytics_zoo_tpu_torch.automl import hp
    from analytics_zoo_tpu_torch.automl.xgboost import (AutoXGBClassifier,
                                                        AutoXGBRegressor)
    from analytics_zoo_tpu_torch.zouwu.config.recipe import \
        XgbRegressorGridRandomRecipe
    cfg = AUTO_XGB
    n, cut = cfg["rows"], cfg["rows"] * 4 // 5
    rng = np.random.RandomState(0)
    x = rng.rand(n, cfg["features"])
    y = (10 * np.sin(np.pi * x[:, 0] * x[:, 1]) + 5 * x[:, 3]
         + 0.2 * rng.randn(n))
    xc = rng.randn(n, cfg["features"])
    yc = (xc[:, 0] + xc[:, 1] > 0).astype(int)
    searches = {
        "regressor": (AutoXGBRegressor, (x, y), "rmse", 2,
                      XgbRegressorGridRandomRecipe(
                          num_rand_samples=2,
                          n_estimators=(cfg["n_estimators"],),
                          max_depth=(4, 6)).search_space([])),
        "classifier": (AutoXGBClassifier, (xc, yc), "error", 3,
                       {"n_estimators": hp.grid_search([cfg["n_estimators"]]),
                        "max_depth": hp.grid_search([4]),
                        "lr": hp.loguniform(1e-2, 3e-1)})}
    leased = "cuda:0" if dev == "cuda" else "cpu"
    results, checks = {}, {}
    for kind, (cls, (xs, ys), metric, n_sampling, space) in searches.items():
        train, val = (xs[:cut], ys[:cut]), (xs[cut:], ys[cut:])
        runs = {}
        for where in (dev, "cpu"):
            t0 = time.perf_counter()
            auto = cls(device=where).fit(train, validation_data=val,
                                         metric=metric, search_space=space,
                                         n_sampling=n_sampling)
            runs[where] = (auto, time.perf_counter() - t0)
        (card_auto, card_s), (cpu_auto, cpu_s) = runs[dev], runs["cpu"]
        trials = card_auto.engine._trials
        pred = card_auto.predict(val[0])
        quality = (float(np.sqrt(np.mean((pred - val[1]) ** 2)))
                   / float(np.std(val[1])) if kind == "regressor"
                   else float(np.mean(pred == val[1])))
        checks[f"{kind}_trials_done_on_{leased}"] = all(
            t.state == "done" and t.device == leased for t in trials)
        checks[f"{kind}_best_config_same_under_cpu_lease"] = \
            card_auto.get_best_config() == cpu_auto.get_best_config()
        checks[f"{kind}_predictions_same_under_cpu_lease"] = bool(
            np.array_equal(pred, cpu_auto.predict(val[0])))
        checks[f"{kind}_beats_baseline"] = (quality < 0.7
                                            if kind == "regressor"
                                            else quality > 0.9)
        results[kind] = {"trials": len(trials),
                         "best_config": card_auto.get_best_config(),
                         "scores": [t.metric_value for t in trials],
                         "rmse_over_std" if kind == "regressor"
                         else "accuracy": quality,
                         "fit_s_leased": card_s, "fit_s_cpu": cpu_s}
    checks = {k: bool(v) for k, v in checks.items()}
    emit({"phase": "auto_xgb", "rows": cfg["rows"],
          "features": cfg["features"], "backend": "bundled hist_gbt",
          "limit": ("determinism: bit for bit against a device='cpu' "
                    "lease of the same host search; JAX parity is "
                    "test_auto_xgb_equals_jax on the CPU"),
          "results": results, "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"AutoXGBoost on the card failed its checks: {checks}")


# --- SSD object-detection serving, BASELINE #5 -------------------------------

def _od_images(n, size, seed):
    """``n`` seeded f32 images in [0, 1), ``(n, size, size, 3)``."""
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(
        np.float32)


def _od_detector(size, classes, model_type, seed=0, device=None):
    from analytics_zoo_tpu_torch.models.image.objectdetection import \
        ObjectDetector
    torch.manual_seed(seed)
    return ObjectDetector(class_names=classes, image_size=size,
                          model_type=model_type, max_gt=4, device=device)


def _od_answers_ok(res, max_det, num_classes):
    """Every answer a finite ``(max_det, 6)`` detection array: labels -1 or
    1..num_classes-1, scores in [0, 1] in descending order, boxes in
    [0, 1]. Returns the number of bad answers."""
    bad = 0
    for v in res:
        a = np.asarray(v)
        if a.shape != (max_det, 6) or not np.isfinite(a).all():
            bad += 1
            continue
        lab, sc = a[:, 0], a[:, 1]
        ok = (np.isin(lab, [-1] + list(range(1, num_classes))).all()
              and (sc >= 0).all() and (sc <= 1).all()
              and (np.diff(sc) <= 0).all()
              and (a[:, 2:] >= 0).all() and (a[:, 2:] <= 1).all())
        bad += not ok
    return bad


def _od_leg(model, broker, client, imgs, batch, max_det, num_classes,
            warm=64):
    """One ``ClusterServing`` leg: start with every bucket up to ``batch``
    warmed, a warm-up burst, then ``len(imgs)`` requests enqueued as one
    burst and dequeued. Returns records/s, request latency percentiles
    (enqueue to the engine's ``t_done``), the engine's stages and the
    number of bad answers."""
    from analytics_zoo_tpu_torch.serving import (ClusterServing, InputQueue,
                                                 OutputQueue)
    from analytics_zoo_tpu_torch.serving.codecs import decode_payload
    serving = ClusterServing(model, queue=broker, batch_size=batch,
                             batch_timeout_ms=OD["timeout_ms"]).start(
        example=imgs[:1])
    try:
        iq, oq = InputQueue(**client), OutputQueue(**client)
        oq.dequeue([iq.enqueue(f"warm-{i}", t=imgs[i % len(imgs)])
                    for i in range(warm)], timeout_s=300)
        serving.reset_metrics()
        sent = {}
        t0 = time.perf_counter()
        for i in range(len(imgs)):
            sent[iq.enqueue(f"r-{i}", t=imgs[i])] = time.time()
        answers, done = [], {}
        for uri in sent:
            raw = oq.broker.get_result(uri, 300)
            if raw is None:
                fail(f"no answer for {uri}")
            data, meta = decode_payload(raw)
            answers.append(data)
            done[uri] = meta.get("t_done", float("nan"))
        dt = time.perf_counter() - t0
        stages = serving.metrics()["stages"]
    finally:
        serving.stop()
    lat = np.array([done[u] - sent[u] for u in sent]) * 1e3
    return {"requests": len(imgs), "seconds": dt,
            "records_per_s": len(imgs) / dt,
            "request_latency_ms": {
                "p50": float(np.percentile(lat, 50)),
                "p95": float(np.percentile(lat, 95)),
                "p99": float(np.percentile(lat, 99)),
                "max": float(lat.max())},
            "stages": stages,
            "bad_answers": _od_answers_ok(answers, max_det, num_classes),
            "answers": np.stack(answers)}


def _od_hold(got, want, tol_score, tol_box, threshold=0.05):
    """Served answers ``got`` against ``want``, the same images' detections
    from the served model's ``predict`` in batch-sized chunks, image by
    image. Random weights put many scores within a few ulps of the score
    threshold and of the ``max_detections`` cut, where the conv algorithm a
    batch's bucket picks decides which candidates survive. So a row is held
    when its score clears its answer's floor (the threshold, or the lowest
    score of a full answer) by 2 * ``tol_score``; it must then have a row
    in the other answer with its label, a score within ``tol_score`` and a
    box within ``tol_box``. Returns the share of identical answers, the
    rows held and ``worst``, the largest distance of a held row to its
    nearest counterpart in units of the limits (1 at the limit; inf where
    no row has its label)."""
    identical, held, worst = 0, 0, 0.0
    for g, w in zip(got, want):
        identical += bool(np.array_equal(g, w))
        for a, b in ((w, g), (g, w)):
            valid = a[:, 0] >= 1
            floor = a[valid, 1].min() if valid.all() else threshold
            rows = a[valid & (a[:, 1] >= floor + 2 * tol_score)]
            if not len(rows):
                continue
            held += len(rows)
            dist = np.maximum(
                np.abs(rows[:, None, 1] - b[None, :, 1]) / tol_score,
                np.abs(rows[:, None, 2:] - b[None, :, 2:]).max(-1)
                / tol_box)
            dist[rows[:, None, 0] != b[None, :, 0]] = np.inf
            worst = max(worst, float(dist.min(1).max()))
    return {"identical_share": identical / len(got), "rows_held": held,
            "worst": worst}


def _od_predict_chunks(model, imgs, batch):
    """``model.predict`` over ``imgs`` in chunks of ``batch``."""
    return np.concatenate([model.predict(imgs[i:i + batch])
                           for i in range(0, len(imgs), batch)])


def od_serve_phase(card):
    """BASELINE #5 through the user's entry points: ``ObjectDetector(...)
    .as_inference_model(max_detections=...)`` (the bf16 trunk on the card,
    decode and NMS in f32) served by ``ClusterServing(batch_size=64,
    batch_timeout_ms=5).start(example=...)``. SSD300 at 300 px and 21
    classes (seeded random weights): 512 f32 requests over
    ``InMemoryBroker``, then 256 uint8 requests over ``RedisBroker`` on
    ``MiniRedisServer`` through a ``rescale(1/255)`` prologue on the card;
    then ``bench_serving_od``'s shape (``ssd_tiny``, 128 px, 3 classes,
    20 detections) over both brokers. Every answer must be a well-formed
    ``[max_detections, 6]`` array, not an error payload, and each leg's
    answers are held against the served model's own ``predict`` on the same
    images in chunks of the batch size (``_od_hold``, TOL_OD_SERVED_*),
    with a control (each answer against the next image's) that must
    miss."""
    from analytics_zoo_tpu_torch.models.image.objectdetection import \
        PASCAL_CLASSES
    from analytics_zoo_tpu_torch.orca.learn.prologue import rescale
    from analytics_zoo_tpu_torch.serving import (InMemoryBroker,
                                                 MiniRedisServer,
                                                 RedisBroker)
    legs, checks, refs = {}, {}, {}
    det = _od_detector(OD["size"], PASCAL_CLASSES, "ssd300")
    model = det.as_inference_model(max_detections=OD["max_det"])
    checks["ssd300_on_card_bf16"] = (
        model.device.type == "cuda" and _on_card(model.module)
        and model.module.serve_dtype == torch.bfloat16)
    imgs = _od_images(OD["requests"], OD["size"], seed=10)
    nc = len(PASCAL_CLASSES) + 1
    broker = InMemoryBroker()
    legs["ssd300_memory_f32"] = _od_leg(
        model, broker, {"queue": broker}, imgs, OD["batch"], OD["max_det"],
        nc)
    refs["ssd300_memory_f32"] = _od_predict_chunks(model, imgs, OD["batch"])
    srv = MiniRedisServer(port=0).start()
    try:
        raw = (imgs[:OD["redis_requests"]] * 255).astype(np.uint8)
        umodel = det.as_inference_model(
            max_detections=OD["max_det"]).set_prologue(rescale(1 / 255))
        client = {"host": srv.host, "port": srv.port, "name": "od300"}
        legs["ssd300_redis_uint8"] = _od_leg(
            umodel, RedisBroker(srv.host, srv.port, stream="od300"), client,
            raw, OD["batch"], OD["max_det"], nc)
        refs["ssd300_redis_uint8"] = _od_predict_chunks(umodel, raw,
                                                        OD["batch"])
        # the prologue ran on the card: the served uint8 path gives what
        # the f32 path gives on the host-rescaled images, batch for batch
        probe = raw[:OD["batch"]]
        checks["prologue_as_host_rescale"] = bool(np.array_equal(
            umodel.predict(probe), model.predict(rescale(1 / 255).host(
                probe))))
        tiny = _od_detector(OD_TINY["size"], OD_TINY["classes"], "ssd_tiny")
        tmodel = tiny.as_inference_model(max_detections=OD_TINY["max_det"])
        timgs = _od_images(OD_TINY["requests"], OD_TINY["size"], seed=11)
        tnc = len(OD_TINY["classes"]) + 1
        broker = InMemoryBroker()
        legs["tiny_memory_f32"] = _od_leg(
            tmodel, broker, {"queue": broker}, timgs, OD_TINY["batch"],
            OD_TINY["max_det"], tnc)
        refs["tiny_memory_f32"] = refs["tiny_redis_f32"] = \
            _od_predict_chunks(tmodel, timgs, OD_TINY["batch"])
        client = {"host": srv.host, "port": srv.port, "name": "odtiny"}
        legs["tiny_redis_f32"] = _od_leg(
            tmodel, RedisBroker(srv.host, srv.port, stream="odtiny"),
            client, timgs, OD_TINY["batch"], OD_TINY["max_det"], tnc)
    finally:
        srv.stop()
    held = {}
    for name, leg in legs.items():
        checks[f"{name}_all_answers_ok"] = leg["bad_answers"] == 0
        got, want = leg.pop("answers"), refs[name]
        held[name] = _od_hold(got, want, TOL_OD_SERVED_SCORE,
                              TOL_OD_SERVED_BOX)
        # the control: each answer against the next image's reference
        held[name]["control_shifted_worst"] = _od_hold(
            got, np.roll(want, 1, 0), TOL_OD_SERVED_SCORE,
            TOL_OD_SERVED_BOX)["worst"]
        checks[f"{name}_as_predict"] = (held[name]["rows_held"] > 0
                                        and held[name]["worst"] <= 1.0)
        checks[f"{name}_control_misses"] = \
            held[name]["control_shifted_worst"] > 1.0
    emit({"phase": "od_serve",
          "config": {"ssd300": OD, "tiny": OD_TINY},
          "legs": legs, "held_against_predict": held,
          "limits": {"score": TOL_OD_SERVED_SCORE, "box": TOL_OD_SERVED_BOX},
          "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"object-detection serving failed its checks: {checks}")
    return model, imgs[:OD["batch"]]


def ssd_forward_flops(module, x):
    """The FLOPs of one SSD forward over ``x`` from its conv shapes, 2 a
    multiply-add (every conv of the trunk and the heads; BatchNorm, ReLU
    and the bias adds are not counted)."""
    from analytics_zoo_tpu_torch.models.image.objectdetection.ssd import \
        SameConv
    total = []

    def hook(mod, _inp, out):
        cout, cin, kh, kw = mod.weight.shape
        total.append(2.0 * out.numel() * cin * kh * kw)
    hooks = [m.register_forward_hook(hook) for m in module.modules()
             if isinstance(m, SameConv)]
    try:
        with torch.inference_mode():
            module(x)
    finally:
        for h in hooks:
            h.remove()
    return sum(total), len(total)


def _od_predict_under_load(model, imgs, rounds=3):
    """Wall ms of ``model.predict`` on the batch (the engine's inference
    stage: H2D, trunk, decode, NMS, D2H), alone and beside one host thread
    that encodes request payloads as a burst client in the same process
    does: the eager NMS loop takes the GIL for each of its ~800 launches."""
    import threading

    from analytics_zoo_tpu_torch.serving.codecs import encode_payload

    def median_ms():
        out = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            model.predict(imgs)
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)
    alone = median_ms()
    stop = threading.Event()

    def client():
        while not stop.is_set():
            encode_payload(imgs[0], meta={"uri": "load"})
    th = threading.Thread(target=client, daemon=True)
    th.start()
    try:
        loaded = median_ms()
    finally:
        stop.set()
        th.join()
    return {"alone": alone, "beside_an_encoding_thread": loaded}


def od_profile_phase(model, imgs, card):
    """Where a served batch of 64 SSD300 images spends its time: CUDA-event
    time of the bf16 trunk alone and of the whole servable (trunk, decode,
    top-k, NMS: JAX's ``trunk_records_per_sec`` and
    ``decode_nms_ms_per_batch``), then torch.profiler over
    OD_PROFILE_BATCHES batches: device busy time, idle share, kernels a
    batch, and the share of them the NMS loop launches (``nms`` alone on
    the batch's candidates); FLOPs from the conv shapes and MFU against the
    bf16 dense peak. And ``predict``'s wall time alone and beside a host
    thread encoding payloads (``_od_predict_under_load``)."""
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        decode_detections, nms)
    serv = model.module
    x = torch.from_numpy(imgs).to("cuda")
    xb = x.to(torch.bfloat16)

    def trunk():
        return serv.trunk(xb)

    def whole():
        return serv(x)
    reps = 10
    with torch.inference_mode():
        loc, conf = trunk()
        for _ in range(3):
            whole()
        torch.cuda.synchronize()
        trunk_ms = [_span_ms(_eager(trunk, reps), reps) for _ in range(5)]
        whole_ms = [_span_ms(_eager(whole, reps), reps) for _ in range(5)]
        post = partial(decode_detections, loc, conf, serv.prior_boxes,
                       max_detections=serv.max_detections)
        post_ms = [_span_ms(_eager(post, reps), reps) for _ in range(5)]
        # the NMS loop alone, on candidate sets of the batch's shape
        cand = torch.rand(len(imgs), 256, 4, device="cuda")
        cand = torch.cat([cand[..., :2], cand[..., :2] + cand[..., 2:]], -1)
        scores = torch.rand(len(imgs), 256, device="cuda")

        def counted(fn, calls):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / calls
            ev = _device_events(prof)
            return ev, wall
        n = OD_PROFILE_BATCHES
        ev_whole, wall_whole = counted(whole, n)
        ev_trunk, _ = counted(trunk, n)
        ev_nms, _ = counted(lambda: nms(cand, scores, 0.45, 100), n)
    if not ev_whole or not ev_trunk:
        fail("the profiler saw no device time in the served batch")
    host = _od_predict_under_load(model, imgs)
    busy = _busy_ms(ev_whole) / n
    flops, n_convs = ssd_forward_flops(serv, xb)
    t_trunk = statistics.median(trunk_ms)
    t_whole = statistics.median(whole_ms)
    by_kernel = {}
    for e in ev_whole:
        tot, c = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (tot + e.time_range.elapsed_us() / 1e3 / n,
                             c + 1)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    kernels_batch = len(ev_whole) / n
    emit({"phase": "od_profile", "batch": len(imgs),
          "image_size": OD["size"], "trunk_dtype": "bfloat16",
          "trunk_ms": t_trunk, "trunk_ms_spread": _spread(trunk_ms),
          "trunk_records_per_sec": len(imgs) / t_trunk * 1e3,
          "trunk_decode_nms_ms": t_whole,
          "whole_ms_spread": _spread(whole_ms),
          "decode_nms_ms_per_batch": t_whole - t_trunk,
          "postprocess_alone_ms": statistics.median(post_ms),
          "records_per_sec_of_batches": len(imgs) / t_whole * 1e3,
          "profiled_wall_ms_per_batch": wall_whole,
          "device_busy_ms_per_batch": busy,
          "device_idle_share": 1.0 - busy / wall_whole,
          "trunk_device_busy_ms": _busy_ms(ev_trunk) / n,
          "kernels_per_batch": kernels_batch,
          "trunk_kernels_per_batch": len(ev_trunk) / n,
          "nms_loop_kernels_per_batch": len(ev_nms) / n,
          "nms_loop_share_of_kernels": len(ev_nms) / n / kernels_batch,
          "top_kernels_ms_per_batch": [
              {"name": k[:120], "ms": v[0], "launches": v[1] / n}
              for k, v in top],
          "predict_wall_ms": host,
          "convs": n_convs, "trunk_flops_per_batch": flops,
          "trunk_flops_per_image": flops / len(imgs),
          "bound_ms": flops / PEAK_BF16 * 1e3,
          "mfu_trunk": flops / (t_trunk / 1e3) / PEAK_BF16,
          "mfu_batch": flops / (t_whole / 1e3) / PEAK_BF16,
          "card": card})


def _od_rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def od_vs_cpu_phase(card):
    """SSD300 from the same seeded weights (running statistics perturbed
    from numpy) on the card and on the CPU, OD_CPU_BATCH images, eval mode:
    loc/conf in f32 (TF32 off on both) against the CPU within TOL_OD_F32,
    the control (the card's bf16 trunk) missing it; the postprocessor on
    the CPU's loc/conf on both sides: the same labels in the same order,
    scores and boxes within TOL_OD_POST; the bf16 trunk against the card's
    f32 within TOL_OD_BF16, the control (the bf16 trunk on the batch in
    reverse order against f32 in order) missing it; and ``quantize()``'s
    weight-only int8 against f32: loc/conf within TOL_OD_INT8 and the
    dequantized weights as a plain per-output-channel quantization, each
    with a control that must miss; detections' agreement reported."""
    import copy

    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        SSDServable, decode_detections, ssd_300)
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    torch.manual_seed(3)
    cpu_net = ssd_300(21).eval()
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for name, b in cpu_net.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.from_numpy(rng.randn(*b.shape).astype(
                    np.float32) * 0.1))
            elif name.endswith("running_var"):
                b.copy_(torch.from_numpy(rng.rand(*b.shape).astype(
                    np.float32) + 0.5))
    card_net = copy.deepcopy(cpu_net).to("cuda")
    # the served trunk: the servable casts the f32 input to bf16
    card_bf16 = SSDServable.of(cpu_net, serve_dtype="bfloat16").to("cuda")
    x = torch.from_numpy(_od_images(OD_CPU_BATCH, OD["size"], seed=12))
    xc = x.to("cuda")
    with torch.inference_mode():
        cl, cc = cpu_net(x)
        gl, gc = card_net(xc)
        bl, bc = card_bf16.trunk(xc)
        rl, rc = card_bf16.trunk(xc.flip(0))
        post_cpu = decode_detections(cl, cc, cpu_net.priors())
        post_card = decode_detections(cl.to("cuda"), cc.to("cuda"),
                                      cpu_net.priors()).cpu()
    readings = {
        "f32_loc": _od_rel(gl, cl), "f32_conf": _od_rel(gc, cc),
        "f32_control_bf16_loc": _od_rel(bl, cl),
        "f32_control_bf16_conf": _od_rel(bc, cc),
        "bf16_loc": _od_rel(bl, gl), "bf16_conf": _od_rel(bc, gc),
        "bf16_control_reversed_loc": _od_rel(rl, gl),
        "bf16_control_reversed_conf": _od_rel(rc, gc),
        "post_scores_boxes": float((post_card[..., 1:] -
                                    post_cpu[..., 1:]).abs().max()),
        "post_detections": int((post_cpu[..., 0] > 0).sum())}
    # weight-only int8 through InferenceModel.quantize, the trunk in f32
    serv = SSDServable.of(cpu_net, serve_dtype="float32")
    im = InferenceModel(device="cuda").load_module(serv)
    f32_dets = im.predict(x.numpy())
    im.quantize()
    q_dets = im.predict(x.numpy())
    # controls: the int8 values left un-dequantized (every scale 1), and
    # the card's dequantized weights against a plain per-output-channel
    # quantization of the f32 weights, computed on the CPU (the card divides
    # by a scalar as a multiply by its reciprocal, an ulp from the host's
    # division, which moves values at a rounding tie a whole step), whose
    # control takes the scales over the input channels instead
    raw_int8 = copy.deepcopy(im.module)
    for name, b in raw_int8.named_buffers():
        if name.endswith("_scale"):
            b.fill_(1.0)
    deq_err, deq_ctrl = 0.0, float("inf")
    with torch.inference_mode():
        ql, qc = im.module.trunk(xc)
        ul, uc = raw_int8.trunk(xc)
        f32_weights = dict(cpu_net.named_modules())
        for name, mod in im.module.named_modules():
            if not getattr(mod, "_int8_weights", ()):
                continue
            w = f32_weights[name].weight
            for axes, into in (((1, 2, 3), "err"), ((0, 2, 3), "ctrl")):
                sc = w.abs().amax(dim=axes, keepdim=True) / 127.0
                sc = torch.where(sc == 0, 1.0, sc)
                plain = torch.clamp(torch.round(w / sc), -127, 127) * sc
                d = float((mod.weight - plain.to(mod.weight.device))
                          .abs().max() / w.abs().max())
                if into == "err":
                    deq_err = max(deq_err, d)
                else:
                    deq_ctrl = min(deq_ctrl, d)
    readings.update({
        "int8_loc": _od_rel(ql, gl), "int8_conf": _od_rel(qc, gc),
        "int8_control_undequantized_loc": _od_rel(ul, gl),
        "int8_control_undequantized_conf": _od_rel(uc, gc),
        "int8_dequantized_vs_plain": deq_err,
        "int8_dequantized_control_input_axis": deq_ctrl,
        "int8_quantized_tensors": sum(
            1 for n, _ in im.module.named_buffers()
            if n.endswith("_int8")),
        "int8_same_label_rows": float(np.mean(
            q_dets[..., 0] == f32_dets[..., 0])),
        "int8_valid_detections": int((q_dets[..., 0] > 0).sum()),
        "f32_valid_detections": int((f32_dets[..., 0] > 0).sum()),
        "int8_sorted_score_max_diff": float(np.abs(
            np.sort(q_dets[..., 1], 1) - np.sort(f32_dets[..., 1],
                                                 1)).max())})
    r = readings
    checks = {
        "f32_within": max(r["f32_loc"], r["f32_conf"]) <= TOL_OD_F32,
        "f32_control_misses": min(r["f32_control_bf16_loc"],
                                  r["f32_control_bf16_conf"]) > TOL_OD_F32,
        "post_same_labels_and_order": bool(torch.equal(
            post_card[..., 0], post_cpu[..., 0])),
        "post_within": r["post_scores_boxes"] <= TOL_OD_POST,
        "bf16_within": max(r["bf16_loc"], r["bf16_conf"]) <= TOL_OD_BF16,
        "bf16_control_misses": min(
            r["bf16_control_reversed_loc"],
            r["bf16_control_reversed_conf"]) > TOL_OD_BF16,
        "int8_within": max(r["int8_loc"], r["int8_conf"]) <= TOL_OD_INT8,
        "int8_control_misses": min(
            r["int8_control_undequantized_loc"],
            r["int8_control_undequantized_conf"]) > TOL_OD_INT8,
        "int8_dequantized_as_plain":
            r["int8_dequantized_vs_plain"] <= TOL_OD_INT8_DEQUANT,
        "int8_dequantized_control_misses":
            r["int8_dequantized_control_input_axis"] > TOL_OD_INT8_DEQUANT,
        "int8_all_quantized": r["int8_quantized_tensors"] == sum(
            1 for p in cpu_net.parameters()
            if p.dim() >= 2 and p.numel() >= 4096)}
    emit({"phase": "od_vs_cpu", "batch": OD_CPU_BATCH, "readings": readings,
          "limits": {"f32": TOL_OD_F32, "post": TOL_OD_POST,
                     "bf16": TOL_OD_BF16, "int8": TOL_OD_INT8,
                     "int8_dequant": TOL_OD_INT8_DEQUANT},
          "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"SSD card vs CPU failed its checks: {checks}")


def _top_iou(dets, boxes, size):
    """Mean IoU of each image's top detection (pixels) with its square; an
    image without a detection counts 0."""
    from analytics_zoo_tpu_torch.models.image.objectdetection.bbox import \
        iou_matrix
    top = torch.from_numpy(np.ascontiguousarray(dets[:, :1, 2:6]))
    gt = torch.from_numpy(np.stack([
        np.asarray(b[:1], np.float32) * size for b in boxes[:len(dets)]]))
    iou = iou_matrix(top, gt)[:, 0, 0].numpy()
    return float(np.mean(np.where(dets[:, 0, 0] > 0, iou, 0.0)))


def od_hot_reload_phase(card, root):
    """A live server of an untrained ``ssd_tiny`` detector (64 px, one
    class, f32 trunk) watches ``root``; ``ObjectDetector.fit`` trains a
    copy from the same seed OD_RELOAD["epochs"] epochs on the toy squares
    (``pack_targets``) on the card and its estimator's ``save_checkpoint``
    writes into ``root``. The server swaps the weights in (``hot_reloads
    == 1``, ``full_reloads == 0``) and its answers then equal the trained
    model's ``predict_image_set`` (labels identical, boxes within
    TOL_OD_RELOAD px). ``save_encrypted`` -> ``load_encrypted`` round-trips
    and a tampered file raises."""
    from analytics_zoo_tpu_torch.models.image.objectdetection import \
        ObjectDetector
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                                 InMemoryBroker, InputQueue,
                                                 OutputQueue)
    size, n = 64, OD_RELOAD["images"]
    rng = np.random.RandomState(13)
    imgs = rng.rand(n, size, size, 3).astype(np.float32) * 0.1
    boxes, labels = [], []
    for i in range(n):
        s = rng.randint(size // 4, size // 2)
        x0, y0 = rng.randint(0, size - s, 2)
        imgs[i, y0:y0 + s, x0:x0 + s] += 0.8
        boxes.append(np.asarray([[x0, y0, x0 + s, y0 + s]]) / size)
        labels.append(np.asarray([1]))
    fresh = _od_detector(size, ("square",), "ssd_tiny", seed=5)
    live = fresh.as_inference_model(max_detections=10,
                                    serve_dtype="float32")
    broker = InMemoryBroker()
    serving = ClusterServing(live, queue=broker, batch_size=8,
                             batch_timeout_ms=5).start(example=imgs[:1])
    try:
        iq, oq = InputQueue(broker), OutputQueue(broker)
        before = np.stack(list(oq.dequeue(
            [iq.enqueue(f"b-{i}", t=imgs[i]) for i in range(16)],
            timeout_s=120).values()))
        live.enable_hot_reload(root, poll_s=0.2)
        det = _od_detector(size, ("square",), "ssd_tiny", seed=5)
        det.compile(optimizer="adam")
        t0 = time.perf_counter()
        stats = det.fit({"x": imgs, "y": det.pack_targets(boxes, labels, 4)},
                        batch_size=OD_RELOAD["batch"],
                        epochs=OD_RELOAD["epochs"], verbose=False)
        fit_s = time.perf_counter() - t0
        det.estimator.save_checkpoint(root, blocking=True)
        t0 = time.perf_counter()
        while live.ckpt_stats().get("hot_reloads", 0) < 1:
            if time.perf_counter() - t0 > 60:
                fail("the live server did not hot-reload the checkpoint")
            time.sleep(0.05)
        swap_s = time.perf_counter() - t0
        after = np.stack(list(oq.dequeue(
            [iq.enqueue(f"a-{i}", t=imgs[i]) for i in range(16)],
            timeout_s=120).values()))
    finally:
        live.disable_hot_reload()
        serving.stop()
    want = det.predict_image_set(imgs[:16], max_detections=10)
    got = after * np.array([1, 1, size, size, size, size], np.float32)
    path = os.path.join(root, "od.enc")
    live.save_encrypted(None, path, "od-passphrase")
    back = InferenceModel(device="cuda").load_encrypted(path,
                                                        "od-passphrase")
    same_back = bool(np.array_equal(back.predict(imgs[:8]),
                                    live.predict(imgs[:8])))
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 1
    open(path, "wb").write(bytes(blob))
    try:
        InferenceModel(device="cuda").load_encrypted(path, "od-passphrase")
        tamper_raises = False
    except ValueError:
        tamper_raises = True
    counters = live.ckpt_stats()
    checks = {
        "hot_reloaded_once": counters.get("hot_reloads") == 1
        and counters.get("full_reloads") == 0,
        "loss_fell": stats[-1]["train_loss"] < stats[0]["train_loss"],
        "answers_changed": not np.array_equal(before, after),
        "answers_are_trained_models": bool(
            np.array_equal(got[..., 0], want[..., 0])
            and np.abs(got[..., 1:] - want[..., 1:]).max() <= TOL_OD_RELOAD),
        "encrypted_round_trip": same_back,
        "tampered_file_raises": tamper_raises}
    emit({"phase": "od_hot_reload", "fit_s": fit_s, "swap_s": swap_s,
          "losses": [s["train_loss"] for s in stats],
          "ckpt_stats": counters,
          "max_diff_px": float(np.abs(got[..., 1:] - want[..., 1:]).max()),
          "top_scores": want[:, 0, 1].tolist()[:4],
          "top_box_iou_with_square": _top_iou(want, boxes, size),
          "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"hot reload on the card failed its checks: {checks}")


def _span_ms(run, calls):
    """CUDA-event time of ``run()`` per one of the ``calls`` it makes."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _eager(fn, reps):
    """``reps`` back-to-back calls, issued from Python as a user would."""
    def run():
        for _ in range(reps):
            fn()
    return run


def _graph(fn, reps):
    """A CUDA graph of ``reps`` back-to-back calls: replaying it times the
    device work alone, free of the host's cost of issuing each call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    return graph.replay


def _time_in_turns(fns, reps=50, rounds=TIMING_ROUNDS, graphs=False):
    """Times several callables in turns: each round runs them in order and
    then in reverse (kernel, library, library, kernel), every span
    ``reps`` calls, eager or (``graphs``) as one CUDA-graph replay.
    Returns {name: [ms per call]}, 2 * rounds spans each; the i-th spans of
    all names come from the same round."""
    runs = {}
    for name, fn in fns.items():
        if graphs:
            runs[name] = _graph(fn, reps)
        else:
            for _ in range(3):
                fn()
            runs[name] = _eager(fn, reps)
    torch.cuda.synchronize()
    samples = {name: [] for name in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(rounds):
        for name in order:
            samples[name].append(_span_ms(runs[name], reps))
    return samples


def _profiled_ms(fns, calls=10, rounds=TIMING_ROUNDS):
    """Device time per call of each of ``fns`` ({name: callable}) from
    torch.profiler, in turns: each round profiles them in order and then
    in reverse, one session of ``calls`` calls each. For calls that do not
    capture in a CUDA graph. A session's reading is, over the kernels (and
    copies) the call launches, each one's median duration in the session
    times its launches per call (at least 1). Sessions lose device records
    (none, or a share of every kernel's, even in all of a run's sessions:
    summing them once read SDPA's backward at 0.035 and 0.094 ms against
    0.19), so a count of records cannot give the time, but the durations
    of the records kept can. A session missing a kernel entirely is
    dropped, and so is the first round. The earlier method, the summed
    durations of a session's records over ``calls`` (sessions with none
    dropped), is read beside it, so the change of method shows in every
    run. Returns ({name: [ms]}, {name: {"kept": sessions kept of sessions
    run, "events": each session's device-record count, "kernels": {kernel:
    [launches per call, median us]}, "record_sum_ms": [ms] a session}})."""
    from torch.profiler import ProfilerActivity, profile
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    sessions = {name: [] for name in fns}       # {kernel: [us]} a session
    order = list(fns) + list(fns)[::-1]
    for r in range(rounds + 1):
        for name in order:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fns[name]()
                torch.cuda.synchronize()
            if not r:
                continue
            durations = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    durations.setdefault(e.name[:96], []).append(
                        e.time_range.elapsed_us())
            sessions[name].append(durations)
    out, info = {}, {}
    for name, xs in sessions.items():
        launches = {}
        for x in xs:
            for kernel, us in x.items():
                launches[kernel] = max(launches.get(kernel, 1),
                                       round(len(us) / calls))
        good = [x for x in xs if launches and set(x) == set(launches)]
        if not good:
            fail(f"the profiler saw no device time for {name}")
        out[name] = [sum(n * statistics.median(x[k])
                         for k, n in launches.items()) / 1e3 for x in good]
        record_sums = [sum(map(sum, x.values())) / 1e3 / calls for x in xs]
        info[name] = {
            "kept": f"{len(good)} of {len(xs)}",
            "record_sum_ms": [t for t in record_sums if t > 0],
            "events": [sum(map(len, x.values())) for x in xs],
            "kernels": {k: [n, statistics.median(
                [us for x in good for us in x[k]])]
                for k, n in launches.items()}}
    return out, info


def _spread(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def _spread_or_none(xs):
    return _spread(xs) if xs else None


def kernels_line(errs, bwd_errs, serve_launches, train_launches,
                 fraud_launches, autots_launches, od_launches,
                 slice_launches):
    """Every kernel at the main paths' shape (B=32, S=128, H=12, D=64, f32,
    q/k/v strided views of the fused projection): the kernel's device time
    (``ms``: CUDA-graph replays in turns) and the time of the PyTorch call
    that computes the same function (``library_ms``: graph replays in
    turns for SDPA's forward, the profiler's device time for its backward,
    which does not capture); both also eagerly in turns (``*_eager``,
    which holds the host's cost of each call); the plain version's time;
    and the bound from the shapes. B2 + B3 are also timed the profiler's
    way, in the same rounds as SDPA's backward
    (``covered_pair_profiled_ms``), so the pair and its library call are
    compared by one method. ``slice_launches``: each kernel's launches on
    the ASHA slice's paths (all 0)."""
    from analytics_zoo_tpu_torch.ops import attention as at
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, s, h, d = BATCH, SEQ, 12, 64
    dtype = torch.float32
    q, k, v = _qkv_views(b, s, s, h, d, dtype, gen)
    g = torch.randn(q.shape, device="cuda", generator=gen)
    kernels = (at.flash_fwd, at.flash_bwd_dq, at.flash_bwd_dkv)
    kept = [fn.launches for fn in kernels]
    o, lse2 = at.flash_fwd(q, k, v, with_lse=True)
    _, delta = at.flash_bwd_dq(q, k, v, o, lse2, g)
    # the library yardstick: SDPA on the same strided (B, H, S, D) views;
    # its backward is autograd.grad of one fixed forward output
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    lib_out = sdpa(*leaves)
    gt = g.transpose(1, 2)
    fwd_fns = {"flash_fwd": lambda: at.flash_fwd(q, k, v),
               "library": lambda: sdpa(qt, kt, vt)}
    bwd_fns = {
        "flash_bwd_dq": lambda: at.flash_bwd_dq(q, k, v, o, lse2, g),
        "flash_bwd_dkv": lambda: at.flash_bwd_dkv(q, k, v, g, lse2, delta),
        "library": lambda: torch.autograd.grad(lib_out, leaves, gt,
                                               retain_graph=True)}
    # device time: CUDA-graph replays in turns; SDPA's backward does not
    # capture in a graph, so its device time comes from the profiler
    dev = _time_in_turns(fwd_fns, graphs=True)

    def pair_fn():
        at.flash_bwd_dq(q, k, v, o, lse2, g)
        at.flash_bwd_dkv(q, k, v, g, lse2, delta)
    profiled, profile_info = _profiled_ms({"library": bwd_fns["library"],
                                           "pair": pair_fn})
    lib_bwd, prof_pair = profiled["library"], profiled["pair"]
    dev.update(_time_in_turns({n: f for n, f in bwd_fns.items()
                               if n != "library"}, graphs=True))
    # eager, as a user calls them: each kernel in turns with its library call
    fwd = _time_in_turns(fwd_fns)
    bwd = _time_in_turns(bwd_fns)
    pair, dev_pair = ([a + c for a, c in zip(t["flash_bwd_dq"],
                                             t["flash_bwd_dkv"])]
                      for t in (bwd, dev))
    plain_ms = {name: statistics.median(t) for name, t in _time_in_turns({
        "flash_fwd": lambda: at.flash_attention_plain(q, k, v),
        "flash_bwd_dq": lambda: at.flash_bwd_dq_plain(q, k, v, o, lse2, g),
        "flash_bwd_dkv": lambda: at.flash_bwd_dkv_plain(q, k, v, g, lse2,
                                                        delta)},
        reps=10).items()}
    for fn, n in zip(kernels, kept):
        fn.launches = n     # timing launches are not the main paths'

    n_el = b * s * h * d * q.element_size()     # one (B, S, H, D) tensor
    n_row = b * h * s * 4                       # one (B*H, S) f32 vector
    work = {  # name: (matmul flops, bytes: inputs read once + outputs)
        "flash_fwd": (4.0 * b * h * s * s * d, 4.0 * n_el),
        # reads q k v o g and lse, writes dq and delta
        "flash_bwd_dq": (6.0 * b * h * s * s * d, 6.0 * n_el + 2.0 * n_row),
        # reads q k v g, lse and delta, writes dk and dv
        "flash_bwd_dkv": (8.0 * b * h * s * s * d,
                          6.0 * n_el + 2.0 * n_row)}
    tensor_cores = "tensor cores, 3xTF32 mma.sync m16n8k8"
    meta = {  # name: (TPU kernel, launches, error, eager ms, library, unit)
        "flash_fwd": ("analytics_zoo_tpu/ops/attention.py:136",
                      serve_launches, errs["f32"], fwd["flash_fwd"],
                      dev["library"], tensor_cores),
        "flash_bwd_dq": ("analytics_zoo_tpu/ops/attention.py:398",
                         train_launches["flash_bwd_dq"],
                         bwd_errs["f32"]["dq"], bwd["flash_bwd_dq"],
                         lib_bwd, tensor_cores),
        "flash_bwd_dkv": ("analytics_zoo_tpu/ops/attention.py:438",
                          train_launches["flash_bwd_dkv"],
                          max(bwd_errs["f32"]["dk"], bwd_errs["f32"]["dv"]),
                          bwd["flash_bwd_dkv"], lib_bwd, tensor_cores)}
    out = []
    for name, (replaces, launches, err, eager, lib, unit) in meta.items():
        flops, nbytes = work[name]
        t_bytes = nbytes / PEAK_BYTES
        t_ops = (3.0 * flops / PEAK_TF32 if dtype == torch.float32
                 else flops / PEAK_BF16)
        t_cuda_cores = flops / PEAK_F32_CUDA_CORES
        ms_s, lib_s = _spread(dev[name]), _spread(lib)
        entry = {"name": name, "route": "cuda",
                 "source": f"analytics_zoo_tpu_torch/csrc/{name}.cu",
                 "replaces": replaces, "launches": launches,
                 "max_abs_err": err, "ms": ms_s["median"],
                 "plain_ms": plain_ms[name],
                 "bound_ms": max(t_ops, t_bytes) * 1e3,
                 "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                 "library_ms": lib_s["median"],
                 "ms_min": ms_s["min"], "ms_max": ms_s["max"],
                 "library_ms_min": lib_s["min"],
                 "library_ms_max": lib_s["max"],
                 "timing": (f"CUDA-graph replays of 50 calls, in turns "
                            f"({TIMING_ROUNDS} rounds x 2 spans)"),
                 "ms_eager": _spread(eager),
                 "bound_cuda_cores_ms": max(t_cuda_cores, t_bytes) * 1e3,
                 "unit": unit, "shape": [b, s, h, d], "dtype": "float32",
                 "flops": flops, "bytes": nbytes}
        if name == "flash_fwd":
            entry["launches_by_path"] = {
                "serve": serve_launches,
                "train": train_launches["flash_fwd"],
                "fraud": fraud_launches["flash_fwd"],
                "autots": autots_launches["flash_fwd"],
                "od_serve": od_launches["flash_fwd"],
                **{path: counts[name]
                   for path, counts in slice_launches.items()}}
            entry["library"] = "scaled_dot_product_attention forward"
            entry["library_timing"] = "CUDA-graph replays, in turns"
            entry["library_ms_eager"] = _spread(fwd["library"])
        else:
            entry["launches_by_path"] = {
                "train": launches, "fraud": fraud_launches[name],
                "autots": autots_launches[name],
                "od_serve": od_launches[name],
                **{path: counts[name]
                   for path, counts in slice_launches.items()}}
            entry["library_covers"] = ["flash_bwd_dq", "flash_bwd_dkv"]
            entry["library"] = ("scaled_dot_product_attention backward "
                                "(autograd.grad of one forward output)")
            entry["library_timing"] = (
                f"torch.profiler device time, "
                f"{profile_info['library']['kept']} sessions of 10 calls "
                f"kept (it does not capture in a CUDA graph)")
            entry["library_profile"] = profile_info["library"]
            # library_ms is median kernel durations times launches; the
            # record sum is how library_ms was read before
            entry["library_ms_record_sum"] = _spread_or_none(
                profile_info["library"]["record_sum_ms"])
            entry["library_ms_eager"] = _spread(bwd["library"])
            entry["covered_pair_ms"] = _spread(dev_pair)
            entry["covered_pair_profiled_ms"] = _spread(prof_pair)
            entry["covered_pair_profiled_timing"] = (
                f"torch.profiler device time, in the same rounds as the "
                f"library's, {profile_info['pair']['kept']} sessions of 10 "
                f"calls kept")
            entry["covered_pair_profile"] = profile_info["pair"]
            entry["covered_pair_profiled_ms_record_sum"] = _spread_or_none(
                profile_info["pair"]["record_sum_ms"])
            entry["covered_pair_ms_eager"] = _spread(pair)
        out.append(entry)
    emit({"kernels": out})


def main():
    card = device_phase()
    import analytics_zoo_tpu_torch  # noqa: F401  (fails outside the repo)
    build_phase()
    errs = kernel_phase()
    bwd_errs = bwd_kernel_phase()
    serve_launches, model, ids = serve_phase(card)
    profile_phase(model, ids, card)
    train_launches, est, data = train_phase(card)
    profile_train_phase(est, data, card)
    train_vs_cpu_phase(card)
    del est, data
    ncf, pairs, ratings = ncf_train_phase(card)
    ncf_profile_phase(ncf, pairs, ratings, card)
    del ncf, pairs, ratings
    ncf_vs_cpu_phase(card)
    embed_bwd_phase(card)
    root = tempfile.mkdtemp(prefix="resnet-")
    try:
        est, pipe, step_ms = resnet_train_phase(card, root)
        resnet_profile_phase(est, pipe, card, step_ms)
        pipe.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del est, pipe
    resnet_vs_cpu_phase(card)
    root = tempfile.mkdtemp(prefix="from-torch-")
    try:
        est, x, y, step_ms = torch_estimator_train_phase(card, root)
        torch_estimator_profile_phase(est, x, y, card, step_ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del est
    torch_estimator_vs_cpu_phase(card)
    torch_operator_fit_phase(x, y, card)
    torch_xshards_fit_phase(x, y, card)
    del x, y
    from analytics_zoo_tpu_torch.ops import attention as at
    kernels = (at.flash_fwd, at.flash_bwd_dq, at.flash_bwd_dkv)
    kept = [fn.launches for fn in kernels]
    for fn in kernels:
        fn.launches = 0
    inner, x, y = fraud_nnframes_train_phase(card)
    fraud_launches = {fn.__name__: fn.launches for fn in kernels}
    for fn, n in zip(kernels, kept):
        fn.launches = n
    fraud_profile_phase(inner, x, y, card)
    del inner, x, y
    fraud_vs_cpu_phase(card)
    root = tempfile.mkdtemp(prefix="keras-csv-")
    try:
        keras_csv_fit_phase(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    optimizers_vs_cpu_phase(card)
    for fn in kernels:
        fn.launches = 0
    root = tempfile.mkdtemp(prefix="autots-")
    try:
        df, rows = autots_trials_phase(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    autots_launches = {fn.__name__: fn.launches for fn in kernels}
    for fn, n in zip(kernels, kept):
        fn.launches = n
    autots_profile_phase(card, df, rows)
    zouwu_vs_cpu_phase(card, df)
    zouwu_real_data_phase(card)
    auto_estimator_search_phase(card)
    # this slice's paths reach no flash kernel: each is driven with the
    # counts at 0 and must leave them there
    slice_launches = {}
    for name, run in (("asha_autots", lambda: asha_autots_phase(card, df)),
                      ("asha_resume", lambda: asha_resume_phase(card)),
                      ("estimator_preemption",
                       lambda: estimator_preemption_phase(card)),
                      ("auto_xgb", lambda: auto_xgb_phase(card))):
        for fn in kernels:
            fn.launches = 0
        run()
        slice_launches[name] = {fn.__name__: fn.launches for fn in kernels}
    if any(n for counts in slice_launches.values() for n in counts.values()):
        fail(f"a flash kernel launched on an ASHA-slice path: "
             f"{slice_launches}")
    for fn in kernels:
        fn.launches = 0
    od_model, od_imgs = od_serve_phase(card)
    od_launches = {fn.__name__: fn.launches for fn in kernels}
    for fn, n in zip(kernels, kept):
        fn.launches = n
    od_profile_phase(od_model, od_imgs, card)
    del od_model, od_imgs
    od_vs_cpu_phase(card)
    root = tempfile.mkdtemp(prefix="od-reload-")
    try:
        od_hot_reload_phase(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    kernels_line(errs, bwd_errs, serve_launches, train_launches,
                 fraud_launches, autots_launches, od_launches,
                 slice_launches)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
