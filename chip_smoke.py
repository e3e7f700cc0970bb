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

* runs a warm-up round and a timed round through ``AutoTSTrainer.fit``:
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

Then, with the serving tier's processes, it

* serves the same SSD300, saved with ``InferenceModel.save``, through
  ``ServingFleet`` worker processes (1 and 4 on the one card) over one
  ``MiniRedisServer`` stream, 256 uint8 requests a leg from a client
  process, each answer held against the parent's ``predict`` and each
  worker pid shown holding card memory (``od_fleet``);
* puts two of the port's HTTP frontends in fleet mode in front of a
  2-worker fleet: 16 f32 JSON requests from a client process, ``/readyz``,
  ``/metrics``, ``/metrics.prom`` and one trace id crossing from a frontend
  into a worker (``http_fleet``);
* SIGKILLs one of two SSD300 workers mid-run: every request answered, the
  dead worker's claims reclaimed, the worker respawned (``fleet_chaos``);
* scales ``SleepModel`` workers from 1 to 2 and overloads one 10x
  (``fleet_topology``, host-only, the JAX bench's gates);
* exports the demo fit's Perfetto timeline through ``python -m
  analytics_zoo_tpu_torch.obs perfetto`` (``obs_export``);
* serves a user's torch module through ``InferenceModel.load_torch``,
  predicts over XShards and counts the transfer bytes
  (``inference_ride_alongs``).

Then, with fused dispatch (config ``steps_per_dispatch``), it

* trains the fraud MLP through ``NNEstimator``, NCF through
  ``NeuralCF.fit``, an AutoTS LSTM and TCN forecaster and the Keras
  ``fit``: the k that ``"auto"`` picks, then fused runs (each group one
  CUDA-graph replay) against unfused ones from the same weights, with
  steady samples/s, the device idle share, graph replays, the final
  parameters held against the eager run's and a fused ``evaluate``
  against an unfused one (``fused_dispatch``);
* trains a 2-layer tiny BERT at k = 4 under torch.profiler: the card
  runs B1-B3 inside the graph replays as often as in the eager fit, and
  the parameters match the eager fit's within TOL_GRAPH
  (``fused_tiny_bert``).

Then, with TCMF (``zouwu/model/tcmf.py``) and the disk-tier FeatureSet
(``feature/feature_set.py``), it

* fits ``TCMFForecaster``'s defaults (rank 64, seasonal period 24) on a
  seeded 370 x 25,968 panel of DeepGLO's electricity shape for 100 epochs
  by CUDA-graph replay, the local hybrid on, and forecasts 24 steps
  (``tcmf_fit``: phase seconds, captures and replays, peak memory, the
  idle share of a profiled fit);
* fits a 48 x 600 panel on the card and on the CPU from the same draws,
  the hybrid off and on, then ``fit_incremental``, and graph replay
  against the eager loop (``tcmf_vs_cpu``); saves the hybrid and loads it
  on the card and on the CPU (``tcmf_save_load``);
* holds the NYC-taxi and long-panel TCMF gates of
  tests/test_zouwu_real_data.py (``tcmf_real_data``);
* trains NCF at MovieLens-1M's row count through ``TPUEstimator.fit`` over
  a disk-tier FeatureSet and over the DRAM tier, checks the disk stream
  card vs CPU and trains a ``from_tfrecords`` set (``featureset_disk_fit``;
  no flash kernel launches on either path).

Then, with the model zoo's text, ranking, sequence, anomaly and
recommendation models, it

* trains the JAX ``TextClassifier``'s defaults (news20's widths: 20
  classes, sequence 500, frozen 200-d GloVe vectors, cnn encoder 256,
  batch 128, Adagrad) for 2 epochs over a seeded synthetic corpus of
  10,000 documents in news20's layout through ``TextSet``, with the
  holdout accuracy gate against the untrained control, a profiled epoch,
  a save and reload, the trainable table and the lstm and gru encoders
  (``text_classifier_news20``);
* takes 3 steps of 12 text models on the card and on the CPU from the
  same weights (``text_models_vs_cpu``);
* trains KNRM at WikiQA's widths, Seq2seq on the reversal task (with
  ``infer``'s tokens against the CPU's), NER and IntentEntity, and times
  a Keras LSTM's loop against its cuDNN branch (``text_family_paths``);
* trains Wide & Deep at MovieLens-1M's widths, SessionRecommender and
  AnomalyDetector on the NYC-taxi series (``recsys_anomaly_paths``; no
  flash kernel launches on any of the four paths).

Then, with image inputs and image classification, it

* decodes every fixture JPEG under ``tests/data/images`` on the card
  with nvJPEG (``csrc/jpeg_decode.cu``, built with the kernels) against
  cv2's decodes stored as PNG, each within limits that a quality-30
  encode of the same picture misses, and every PNG and BMP fixture bit
  for bit; times the decode (``image_codecs``);
* reads 256 JPEGs in two class folders through ``ImageSet.read`` (decoded
  on the card), applies ``imagenet_val_transforms(224)`` and scores them
  with ``ImageClassifier("inception-v1", num_classes=1000)`` in bf16 at
  batch 256, top-5 (``image_classifier_inception_v1``, the main path);
* trains ``ImageClassifier("mobilenet-v2")`` 8 steps of 64 on the same
  ``ImageSet.to_dataset()`` (``mobilenet_v2_fit``);
* holds the 8 image modules on the card against the CPU at 64 px, f32
  (``image_families_vs_cpu``);
* predicts with ``ObjectDetector(model_type="ssd_mobilenet_v2")`` at 300
  px from an ImageSet, and holds its outputs, detections and 2 Adam
  steps against the CPU (``ssd_mobilenet_v2_paths``; no flash kernel
  launches on any of the five paths).

Then, with the TF-migration surface (keras2, tfpark, GANEstimator, the
pipeline Estimator), it

* trains a GPT-1-width ``TransformerLayer`` (the JAX defaults: vocab
  40,990, sequence 77, 12 causal blocks of 12 heads, hidden 768, flash)
  under a keras2 head through ``tfpark.KerasModel`` and
  ``ZooOptimizer(Adam, 4)`` over ``TFDataset.from_text_set`` of 2,048
  news20-layout documents, 16 micro-steps of batch 32, then evaluates and
  predicts; a profiled window counts B1-B3 on the card
  (``tfpark_transformer_fit``, the main path: every block runs the three
  kernels);
* takes 8 micro-steps of the same model cut to 2 blocks on the card and
  on the CPU (``tfpark_vs_cpu``);
* trains examples/gan/mnist_gan.py's generator and discriminator through
  ``GANEstimator`` for 20 epochs (``gan_fit``) and holds 2 D+G
  alternations against the CPU (``gan_vs_cpu``);
* steps a keras2 MLP 20 times through the pipeline ``Estimator``'s
  ``train_minibatch`` with L2-norm clipping, card against CPU
  (``pipeline_estimator_minibatch``; no flash kernel launches on the GAN
  and pipeline paths).

Then, after the kernels' timings, with the streaming plane and the
training supervisor (``examples/streaming/online_ncf.py`` at NCF's
MovieLens-1M widths, f32, Adam), it

* trains 8 count windows of a drifting Redis request stream through
  ``StreamingXShards`` and ``StreamingTrainer`` while a
  ``StreamingReloader`` swaps each commit into a served copy: 8 reloads,
  no capture after window 1, freshness p50/p99, and the probe user's
  served ranking flips after the drift while a copy without the reloader
  keeps its own (``streaming_ncf_online``, the main path);
* trains the first 3 windows with 4 steps a dispatch: one CUDA graph
  captured in window 1 and replayed after, the weights the eager run's,
  while a thread predicts through every swap (``streaming_fused_windows``);
* stops the trainer by SIGTERM while window 2 accumulates and resumes it
  from its checkpoint: NCF and the linear model as the uninterrupted runs
  (``streaming_resume``);
* runs a 2-consumer ``StreamingFleet`` over a 2-partition stream with
  ``FleetReloaders``, SIGKILLs one consumer (no record lost or trained
  twice), and gates a linear model's commits with the
  ``GuardrailEvaluator`` through a poisoned window (``streaming_fleet``);
* fits NCF under ``TrainingSupervisor`` through a watchdog-tripped hang
  and an injected device loss, as an unsupervised fit (``supervised_fit``;
  no flash kernel launches on any of the five paths).

Then, with Friesian and Parquet input (``examples/friesian/
recsys_feature_engineering.py`` at 1,000,000 click rows), it

* engineers the click log with ``FeatureTable`` (string indices, median
  fill, clip, log, normalize, encode, the city x device cross), round-trips
  the table and the user index through Parquet, trains Wide & Deep at the
  example's widths 1 epoch at batch 512 with Adam, holds the example's
  holdout gate and 2 steps against the CPU (``friesian_wnd``);
* builds session features from 100,000 rows (negative samples, item and
  negative histories, mask and pad, lengths) and trains SessionRecommender
  at the JAX defaults with history (``friesian_session``);
* writes 60,000 MNIST-shaped uint8 digits with ``write_ndarrays``, fits a
  user's LeNet-5 from ``ParquetDataset.read_as_xshards`` through
  ``TPUEstimator`` with ``profile=<dir>`` and reads the trace's kernels
  back, holds ``read_as_torch`` to the shards and reads a TextSet parquet
  table (``parquet_fit``; no flash kernel launches on the three paths).

Each phase prints one JSON line; any failure raises and exits non-zero.
The ``kernels`` line lists every kernel with its time, bound, plain and
library times; the last line is ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""

import collections
import concurrent.futures
import contextlib
import copy
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from functools import partial

# the smoke's own timeline (``at_s`` on each phase line) starts before
# numpy and torch load
_T0 = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402

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
# The second step follows one Adam update. The port's card optimizer is
# built capturable (so that a fused group captures as a CUDA graph), which
# computes the bias corrections 1 - beta^t in float32 on the device (as
# optax does); the CPU's, built with a float lr, computes them in Python's
# double. 1 - 0.999 differs by 1.3e-5 between the two, so every weight's
# first update moves by up to 1.5e-5 of the lr; that flips one ReLU of
# 4.2M in the first layer and one of 2.1M in the second, and a flipped
# row's share of the first layer's weight gradient reads 1.5e-3 of that
# gradient's largest entry (5e-3), while the loss moves by 1.6e-6
# (scripts/fraud_adam_bias_correction.py reproduces all of it on the CPU
# alone). The witness run, the card's Adam built with a float lr and
# without capturable (bias corrections in double), is held to TOL_FRAUD
# on both steps. Second-step readings on an H100 80GB HBM3 at 700 W:
# capturable 1.55e-3 (loss 1.5e-6), witness 3.7e-7 (loss 6.4e-8); the
# control, the batches swapped, reads 0.191 (loss 4.7e-4).
TOL_FRAUD_SECOND = {"loss": TOL_STEP_LOSS, "grad": 1e-2}
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
# round, then AUTOTS["rounds"] timed rounds (the bench's 3; 1 since PR
# 16, which needed the ~38 s two more rounds took to keep the whole smoke
# near 800 s after its image phases). The warm-up round runs one draw a
# recipe (4 trials) since PR 18: every shape and kernel of the timed
# round is met in it all the same.
AUTOTS = dict(points=2000, horizon=1, n_rand=2, epochs=5, rounds=1,
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
# LSTM's 0.0219-0.0273 (H100 80GB HBM3, 700 W). Seeds 0-2 since the
# TF-migration slice, whose phases needed the ~25 s seeds 3-4 took (here
# and in tcmf_real_data) to keep the whole smoke under 800 s; seed 0
# since the streaming slice, whose phases needed the ~22 s seeds 1-2 took.
REAL_DATA_SEEDS = (0,)
# AutoTS under the ASHA TrialRuntime (scheduler="asha", eta 3, grace 1):
# each recipe of autots_trials at 5 random draws (x the batch-size grid of
# 2: 10 trials a recipe) and a 9-epoch budget, so the rungs are [1, 3, 9];
# the same recipe and seed under the default scheduler is the exhaustive
# search (90 epochs a recipe). The ASHA winner's MSE must be within
# ASHA_WINNER_FACTOR of the exhaustive best: the JAX suite's tolerance
# (tests/test_trial_scheduler.py, test_auto_estimator_asha_end_to_end).
# 3 draws (6 trials, 54 exhaustive epochs a recipe, rungs reporting 6, 2
# and 1) since the TF-migration slice, which needed the ~45 s the other 2
# draws took to keep the whole smoke under 800 s; the TCN recipe alone
# since the streaming slice, which needed the LSTM recipe's ~42 s (its
# last reading: 16 of 54 epochs, winner 1.073 x the exhaustive best; the
# LSTM recipe still runs in autots_trials).
ASHA_AUTOTS = dict(n_rand=3, epochs=9, eta=3, grace_period=1)
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


# The serving tier's processes (slice 12): the SSD300 above (OD's widths,
# bf16 trunk, batch 64, 5 ms timeout, 100 detections) served by
# ServingFleet worker processes on the one card over one MiniRedisServer
# stream (claim_idle_ms 800), M = 4 (1 and 2 as well before the
# TF-migration and streaming slices, which needed the ~25 s and ~12 s
# those legs took to keep the whole smoke under 800 s); a client process
# sends a
# warm-up of 64 requests a worker, then 256 uint8 requests as one burst.
# A worker admits at most two batches (max_inflight 128, as the JAX
# bench's fleet), so the backlog stays on the stream for every worker.
# http_fleet: two HTTP frontends, 16 f32 JSON requests to 2 workers.
# Answers are held with TOL_OD_SERVED_* (the workers' batches pad to other
# buckets than the parent's predict chunks).
FLEET = dict(workers=(4,), requests=256, warm_per_worker=64,
             claim_idle_ms=800, http_requests=16, frontends=2,
             live_timeout_s=300)
# fleet_topology: the JAX bench's legs 1-3 (bench.py bench_serving_fleet)
# on SleepModel, 100 ms a batch of 4 (40 records/s a worker). Gates, the
# JAX smoke's: 2-worker goodput >= 1.5x the 1-worker goodput (reading ~2x;
# control, one worker at 10x offered load, ~1x, must miss); admitted p99
# under 10x overload <= deadline 600 ms + 150 ms (reading ~deadline or
# less; control, the same overload with a deadline nothing reaches, queues
# for seconds, must miss).
TOPOLOGY = dict(batch_ms=100.0, batch=4, dur_s=3.0, deadline_s=2.5,
                over_dur_s=1.5, over_deadline_s=0.6, control_dur_s=0.5,
                scaleout_min=1.5, p99_slack_ms=150.0)
OBS_DEMO_STEPS = 8
# A user's torch MLP through InferenceModel.load_torch, served by
# ClusterServing: answers against the module's own forward on the card,
# relative to the largest, f32 with TF32 off (served batches pad to other
# buckets, so other GEMM shapes: f32 ulps); the control, the answers
# shifted by one row, must miss.
RIDE = dict(rows=200, features=64, hidden=256, classes=10)
TOL_LOAD_TORCH = 1e-5


def emit(obj):
    """One JSON line; a phase's line also carries the script's seconds so
    far (``at_s``), the smoke's own timeline."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _T0, 3)}
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
    """Builds every library of ``csrc/`` (one nvcc each, all at once): the
    flash kernels and the nvJPEG decoder (``jpeg_decode``, which ports no
    TPU kernel, linked against the toolkit's nvJPEG); reports ptxas's
    registers and spills per flash kernel instance, the HMMA count of each
    flash library's SASS, and the shared memory and CTAs per SM of each
    flash kernel. Fails if a flash kernel has no tensor-core instruction
    or spills at D = 64."""
    from analytics_zoo_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    libs = _kernels.build_all()
    seconds = time.perf_counter() - t0
    flash = [name for name in libs if name in FLASH_KERNELS]
    ptxas = {name: _kernels.ptxas_report(name) for name in flash}
    hmma = {name: _sass_mma_count(libs[name]) for name in flash}
    occupancy = {
        name: {f"{dt}_d{d}": _kernels.occupancy(name, code, d)
               for dt, code in (("f32", 0), ("bf16", 1)) for d in (64, 128)}
        for name in flash}
    emit({"phase": "build", "seconds": round(seconds, 3),
          "libraries": {k: os.path.relpath(v) for k, v in libs.items()},
          "link": {name: _kernels.link_flags(name) for name in libs
                   if _kernels.link_flags(name)},
          "ptxas": ptxas, "sass_hmma": hmma, "occupancy": occupancy})
    if sorted(flash) != sorted(FLASH_KERNELS) or "jpeg_decode" not in libs:
        fail(f"build: libraries {sorted(libs)}")
    for name in flash:
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
             ("f32_causal_s2048", torch.float32, 2048, 2048, True),
             # the TF-migration main path's shape: GPT-1's 77, no tile
             # multiple, so the last tile of each row and column is ragged
             ("f32_causal_s77", torch.float32, 77, 77, True)]
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
             ("f32_causal_s2048", torch.float32, 2048, 2048, True),
             ("f32_causal_s77", torch.float32, 77, 77, True)]
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
    # an "auto" fit's probe runs real (rolled-back) steps first
    run = steps + est.probe_steps
    for name, n in launches.items():
        if n != n_layers * run:
            fail(f"{name} launched {n} times in {steps} steps and "
                 f"{est.probe_steps} probe steps of a {n_layers}-layer "
                 f"model (expected {n_layers * run})")
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
          "fuse": est.fuse, "probe_steps": est.probe_steps,
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
    from analytics_zoo_tpu_torch.orca.learn import graphs
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
        before = dict(graphs.CAPTURES), dict(graphs.REPLAYS)
        t_fit = time.perf_counter()
        stats = model.fit(data, epochs=NCF_EPOCHS, batch_size=NCF_BATCH,
                          verbose=False, profile=True,
                          checkpoint_trigger=EveryEpoch())
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t_fit
        row_sum.restore()
        matmul.restore()                                # ... and ends here
        captures = graphs.CAPTURES["train"] - before[0]["train"]
        replays = graphs.REPLAYS["train"] - before[1]["train"]
        peak = torch.cuda.max_memory_allocated()
        pipe = model.estimator.data_pipeline_stats()
        step_ms = [t for s in stats for t in s["profile"]["step_ms"]]
        losses = [s["train_loss"] for s in stats]
        if len(step_ms) != steps or not all(map(math.isfinite, losses)):
            fail(f"NCF fit: {len(step_ms)} steps (expected {steps}), "
                 f"losses {losses}")
        # the counters see the backward's Python calls, two a step: the
        # eager steps (every step no replay ran), the
        # auto probe's rolled-back steps, and the k steps of each capture
        # (a graph replay runs the captured kernels and no Python)
        k = model.estimator.fuse
        python_steps = (steps - k * replays + k * captures
                        + model.estimator.probe_steps)
        if row_sum.calls != 2 * python_steps or matmul.calls:
            fail(f"NCF backward took the row sum {row_sum.calls} times and "
                 f"the one-hot matmul {matmul.calls} times in {steps} "
                 f"steps at k {k} with {replays} replays, {captures} "
                 f"captures and {model.estimator.probe_steps} probe steps "
                 f"(expected {2 * python_steps} and 0)")
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
              "fuse": model.estimator.fuse,
              "probe_steps": model.estimator.probe_steps,
              "graph_captures": captures, "graph_replays": replays,
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
    """Records the lr each optimizer step applies (param group 0; on the
    card a float32 device tensor, read here as its float)."""

    def __init__(self, opt):
        self.opt, self.inner, self.lrs = opt, opt.step, []
        opt.step = self

    def __call__(self, *args, **kwargs):
        self.lrs.append(float(self.opt.param_groups[0]["lr"]))
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
    # the schedule's lr as the step applies it: rounded to float32
    want_lr = [float(np.float32(sched.lr_at(k, 0.0))) for k in range(steps)]
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
    witness_run = _fraud_steps(dev, state, batches,
                               optimizer=lambda params: torch.optim.Adam(
                                   params, lr=1e-3, betas=(0.9, 0.999),
                                   eps=1e-8, capturable=False))

    def readings(run, step):
        return {"loss": abs(run[0][step] - cpu_run[0][step])
                / abs(cpu_run[0][step]),
                "grad": max(_rel_err(run[1][step][k], cpu_run[1][step][k])
                            for k in cpu_run[1][step])}
    got = [readings(card_run, s) for s in (0, 1)]
    control = [readings(control_run, s) for s in (0, 1)]
    witness = [readings(witness_run, s) for s in (0, 1)]
    limits = (TOL_FRAUD, TOL_FRAUD_SECOND)
    held = all(r[k] <= lim[k] for r, lim in zip(got, limits) for k in lim)
    witness_held = all(r[k] <= TOL_FRAUD[k] for r in witness
                       for k in TOL_FRAUD)
    rejected = all(r[k] > lim[k] for r, lim in zip(control, limits)
                   for k in lim)
    emit({"phase": "fraud_vs_cpu", "batch": FRAUD["batch"], "steps": 2,
          "optimizer": "adam (NNEstimator's default)",
          "loss_card": card_run[0], "loss_cpu": cpu_run[0],
          "readings": got, "limits": [TOL_FRAUD, TOL_FRAUD_SECOND],
          "control": "the card with the two batches swapped",
          "control_readings": control, "control_rejected": rejected,
          "witness": "the card's Adam with a float lr, not capturable",
          "witness_readings": witness, "witness_limit": TOL_FRAUD,
          "witness_held": witness_held,
          "run_s": time.perf_counter() - t0, "card": card})
    if not (held and rejected and witness_held
            and all(map(math.isfinite, card_run[0]))):
        fail(f"fraud steps on the card disagree with the CPU: {got}, "
             f"witness {witness}, control {control}")


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


def _autots_recipes(n_rand=None):
    from analytics_zoo_tpu_torch.zouwu.config.recipe import (
        LSTMGridRandomRecipe, TCNGridRandomRecipe)
    n_rand = n_rand or AUTOTS["n_rand"]
    return [LSTMGridRandomRecipe(num_rand_samples=n_rand,
                                 epochs=AUTOTS["epochs"]),
            TCNGridRandomRecipe(num_rand_samples=n_rand,
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
    for recipe in _autots_recipes(n_rand=1):
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
    """AutoTS's TCN recipe at ASHA_AUTOTS through ``AutoTSTrainer.fit(...,
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
    from analytics_zoo_tpu_torch.zouwu.config.recipe import \
        TCNGridRandomRecipe
    cfg = ASHA_AUTOTS
    leased = "cuda:0" if dev == "cuda" else "cpu"
    recipes = [TCNGridRandomRecipe(num_rand_samples=cfg["n_rand"],
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


# --- the serving tier's processes: fleet workers, HTTP frontends, obs -------

FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _report_launches(report_dir, model, method="predict"):
    """Has this process report its own flash-kernel launch counts (each
    wrapper's ``.launches``) in ``report_dir/launches-<pid>.json``: now,
    after every ``model.<method>`` call (``predict``; a streaming
    trainer's estimator: ``fit``) that changed them, and at exit. A
    SIGKILLed worker's file holds its counts as of its last finished
    call."""
    import atexit

    from analytics_zoo_tpu_torch.ops import attention as at
    kernels = [getattr(at, name) for name in FLASH_KERNELS]
    path = os.path.join(report_dir, f"launches-{os.getpid()}.json")
    written = {}

    def write():
        counts = {fn.__name__: fn.launches for fn in kernels}
        if counts != written:
            with open(path + ".tmp", "w") as f:
                json.dump({"pid": os.getpid(), "launches": counts}, f)
            os.replace(path + ".tmp", path)
            written.update(counts)

    call = getattr(model, method)

    def counted_call(*args, **kwargs):
        try:
            return call(*args, **kwargs)
        finally:
            write()

    setattr(model, method, counted_call)
    write()
    atexit.register(write)


def _counted_factory(report_dir, factory):
    """A fleet worker's model factory whose worker reports its own kernel
    launches (``_report_launches``); module-level, so it pickles across
    the spawn boundary."""
    model = factory()
    _report_launches(report_dir, model)
    return model


def _worker_launches(report_dir):
    """The workers' launch reports in ``report_dir``: each worker's
    counts by pid, and their sum by kernel."""
    per = {}
    for name in os.listdir(report_dir):
        if name.startswith("launches-") and name.endswith(".json"):
            with open(os.path.join(report_dir, name)) as f:
                rep = json.load(f)
            per[rep["pid"]] = rep["launches"]
    return per, {k: sum(c[k] for c in per.values()) for k in FLASH_KERNELS}


def _fleet_model(path, uint8, report_dir):
    """A fleet worker's model factory (module-level, so it pickles across
    the spawn boundary): the saved SSD300 servable loaded onto the card,
    with the ``rescale(1/255)`` prologue when requests travel as uint8,
    every bucket up to the batch warmed (as ``ClusterServing.start(
    example=...)`` warms an embedded engine). Writes the worker's pid,
    device and the card memory it holds to ``report_dir``."""
    from analytics_zoo_tpu_torch.orca.learn.prologue import rescale
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    model = InferenceModel().load(path)
    if uint8:
        model.set_prologue(rescale(1 / 255))
    model.precompile(np.zeros((1, OD["size"], OD["size"], 3),
                              np.uint8 if uint8 else np.float32),
                     max_bucket=OD["batch"])
    with open(os.path.join(report_dir, f"worker-{os.getpid()}.json"),
              "w") as f:
        json.dump({"pid": os.getpid(), "device": str(model.device),
                   "params_on_card": _on_card(model.module),
                   "serve_dtype": str(model.module.serve_dtype),
                   "cuda_allocated_bytes": torch.cuda.memory_allocated()},
                  f)
    return model


def _wait_go(go):
    if not go.wait(FLEET["live_timeout_s"] + 120):
        raise RuntimeError("the fleet never went live")


def _fleet_client(go, spec, imgs_path, out_path, warm, prefix):
    """One fleet leg's client, in its own process (``_start_client``):
    once ``go`` is set, ``warm`` untimed requests, then every image in
    ``imgs_path`` enqueued as one burst through ``InputQueue`` and each
    answer fetched. Writes the answers, each request's latency (enqueue to
    the engine's ``t_done``), the leg's wall time and the client's CPU
    time to ``out_path``."""
    from analytics_zoo_tpu_torch.serving import InputQueue, OutputQueue
    from analytics_zoo_tpu_torch.serving.codecs import decode_payload
    imgs = np.load(imgs_path)
    _wait_go(go)
    iq, oq = InputQueue(spec), OutputQueue(spec)
    oq.dequeue([iq.enqueue(f"{prefix}-warm-{i}", t=imgs[i % len(imgs)])
                for i in range(warm)], timeout_s=600)
    cpu0, t0 = time.process_time(), time.perf_counter()
    sent = {}
    for i in range(len(imgs)):
        sent[iq.enqueue(f"{prefix}-{i}", t=imgs[i])] = time.time()
    answers, latency = [], []
    for uri, t_sent in sent.items():
        raw = oq.broker.get_result(uri, 600)
        if raw is None:
            raise RuntimeError(f"no answer for {uri}")
        data, meta = decode_payload(raw)
        if meta.get("error"):
            raise RuntimeError(f"{uri}: {meta['error']}")
        answers.append(data)
        latency.append(meta.get("t_done", float("nan")) - t_sent)
    np.savez(out_path, answers=np.stack(answers),
             latency_s=np.array(latency),
             seconds=time.perf_counter() - t0,
             client_cpu_s=time.process_time() - cpu0)


def _http_client(go, ports, imgs_path, out_path):
    """The HTTP leg's client, in its own process (``_start_client``): once
    ``go`` is set, each f32 image as one ``POST /predict`` JSON body,
    alternately to the frontends, four requests in flight."""
    import http.client
    from concurrent.futures import ThreadPoolExecutor
    imgs = np.load(imgs_path)
    _wait_go(go)

    def post(i):
        conn = http.client.HTTPConnection("127.0.0.1", ports[i % len(ports)],
                                          timeout=600)
        try:
            t0 = time.perf_counter()
            conn.request("POST", "/predict", body=json.dumps(
                {"instances": [imgs[i].tolist()]}),
                headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            body = r.read()
            if r.status != 200:
                raise RuntimeError(f"request {i}: {r.status} {body[:200]}")
            return (np.asarray(json.loads(body)["predictions"][0],
                               np.float32), time.perf_counter() - t0)
        finally:
            conn.close()

    with ThreadPoolExecutor(4) as pool:
        out = list(pool.map(post, range(len(imgs))))
    np.savez(out_path, answers=np.stack([a for a, _ in out]),
             latency_s=np.array([t for _, t in out]))


def _start_client(target, *args):
    """Starts ``target(go, *args)`` in a spawned process, so that it
    imports while the fleet spawns; it begins once ``go`` is set. Returns
    the process and ``go``."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    go = ctx.Event()
    p = ctx.Process(target=target, args=(go, *args), name="fleet-client")
    p.start()
    return p, go


def _join_client(p, timeout_s=900):
    """Waits for a ``_start_client`` process; fails on a non-zero exit or
    the time limit."""
    p.join(timeout_s)
    if p.is_alive():
        p.kill()
        p.join()
        fail(f"{p.name} did not finish in {timeout_s} s")
    if p.exitcode != 0:
        fail(f"{p.name} exited {p.exitcode}")


def _gpu_apps():
    """``[[pid, used MiB], ...]`` of the processes nvidia-smi lists on the
    card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [[int(pid), float(mem)] for pid, mem in (
        (f.strip() for f in line.split(",")) for line in
        out.strip().splitlines())]


def _worker_reports(report_dir):
    """The workers' own reports (``_fleet_model``) and their final engine
    metrics (the drain snapshot ``ServingFleet`` writes to its
    ``trace_dir``)."""
    reports, metrics = {}, {}
    for name in os.listdir(report_dir):
        with open(os.path.join(report_dir, name)) as f:
            if name.startswith("worker-"):
                rep = json.load(f)
                reports[rep["pid"]] = rep
            elif name.startswith("metrics-"):
                metrics[name[len("metrics-"):-len(".json")]] = json.load(f)
    return reports, metrics


def _stage_summary(metrics):
    """Each worker's engine stages: count and p50/p95 ms."""
    return {wid: {stage: {k: v for k, v in s.items()
                          if k in ("count", "p50_ms", "p95_ms")}
                  for stage, s in m.get("stages", {}).items()}
            for wid, m in metrics.items()}


def _fleet_spec(srv, stream):
    return (f"redis://{srv.host}:{srv.port}/{stream}"
            f"?claim_idle_ms={FLEET['claim_idle_ms']}")


def _start_fleet(path, spec, workers, uint8, report_dir, **kw):
    """A ServingFleet of ``workers`` SSD300 workers on the card, live;
    returns it and the seconds from spawn to ``wait_live``."""
    from analytics_zoo_tpu_torch.serving import ServingFleet
    os.makedirs(report_dir, exist_ok=True)
    t0 = time.perf_counter()
    fleet = ServingFleet(
        partial(_counted_factory, report_dir,
                partial(_fleet_model, path, uint8, report_dir)), spec,
        workers=workers, autoscale=False, batch_size=OD["batch"],
        batch_timeout_ms=OD["timeout_ms"], max_inflight=2 * OD["batch"],
        drain_s=60.0, trace_dir=report_dir, **kw).start()
    deadline = time.time() + FLEET["live_timeout_s"]
    while not fleet.wait_live(workers, 1.0):
        # with autoscale off nothing retires a worker: a restart before
        # the fleet is live is a worker that died starting
        if fleet.metrics()["restarts"] or time.time() > deadline:
            snap = fleet.stop(timeout_s=60)
            fail(f"{workers} fleet workers never went live: {snap}")
    return fleet, time.perf_counter() - t0


def _on_card_checks(name, fleet_pids, reports, before, apps, after):
    """Each worker holds memory on the card and reports its model's
    parameters on cuda. nvidia-smi lists one row per process holding a
    CUDA context on the card, under pids of its own namespace (on the
    card's machine no row carries a worker's pid), so the rows are
    counted: the listing taken while the fleet served must hold one row
    more a worker than ``before`` (taken before the fleet started), each
    row with memory; the control, ``after`` (taken once the fleet
    stopped), must be back to ``before``'s rows."""
    return {
        f"{name}_workers_hold_card_memory": (
            len(apps) - len(before) == len(fleet_pids)
            and all(mib > 0 for _, mib in apps)),
        f"{name}_control_rows_back_after_stop": len(after) == len(before),
        f"{name}_workers_report_cuda": all(
            reports.get(pid, {}).get("params_on_card")
            and reports[pid]["device"].startswith("cuda")
            and reports[pid]["cuda_allocated_bytes"] > 0
            for pid in fleet_pids)}


def _held(got, want, name, checks):
    held = _od_hold(got, want, TOL_OD_SERVED_SCORE, TOL_OD_SERVED_BOX)
    held["control_shifted_worst"] = _od_hold(
        got, np.roll(want, 1, 0), TOL_OD_SERVED_SCORE,
        TOL_OD_SERVED_BOX)["worst"]
    checks[f"{name}_as_predict"] = (held["rows_held"] > 0
                                    and held["worst"] <= 1.0)
    checks[f"{name}_control_misses"] = held["control_shifted_worst"] > 1.0
    return held


def fleet_fixture(root):
    """SSD300 as ``od_serve`` builds it (300 px, 21 classes, 100
    detections, bf16 trunk on the card), saved with
    ``InferenceModel.save``; FLEET["requests"] seeded uint8 images and
    FLEET["http_requests"] f32 ones; and the parent's own ``predict`` of
    the saved model on the card over both, in chunks of the batch."""
    from analytics_zoo_tpu_torch.models.image.objectdetection import \
        PASCAL_CLASSES
    from analytics_zoo_tpu_torch.orca.learn.prologue import rescale
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    det = _od_detector(OD["size"], PASCAL_CLASSES, "ssd300")
    path = os.path.join(root, "ssd300.pt")
    det.as_inference_model(max_detections=OD["max_det"]).save(None, path)
    del det
    f32 = _od_images(FLEET["http_requests"], OD["size"], seed=13)
    u8 = (_od_images(FLEET["requests"], OD["size"], seed=12)
          * 255).astype(np.uint8)
    paths = {"uint8": os.path.join(root, "uint8.npy"),
             "f32": os.path.join(root, "f32.npy")}
    np.save(paths["uint8"], u8)
    np.save(paths["f32"], f32)
    ref = InferenceModel().load(path)
    want = {"f32": _od_predict_chunks(ref, f32, OD["batch"])}
    ref.set_prologue(rescale(1 / 255))
    want["uint8"] = _od_predict_chunks(ref, u8, OD["batch"])
    return {"path": path, "imgs": paths, "want": want,
            "num_classes": len(PASCAL_CLASSES) + 1}


def od_fleet_phase(card, root, fx):
    """SSD300 served by ``ServingFleet`` worker processes over one
    ``MiniRedisServer`` stream (``claim_idle_ms`` 800), with M = 1 and 4
    workers on the one card, ``autoscale=False``, batch 64; each worker
    loads the saved model through ``_fleet_model`` (uint8 requests, the
    prologue on the card). A client process sends a warm-up of 64
    requests a worker, then FLEET["requests"] as one burst, and fetches
    every answer; it starts with the fleet and begins once the workers
    are live. Per M: records/s, p50/p99 latency, spawn to ``wait_live``,
    each worker's heartbeat stats and engine stages, the parent's CPU
    seconds (the broker's thread and the supervisor) and the client's,
    and the client's wall time from the go to its exit. Every answer is held against the parent's ``predict`` of
    the saved model (``_od_hold``, TOL_OD_SERVED_*), with the answers
    shifted by one image as the control; every worker pid must hold
    memory on the card. Returns the workers' own flash-kernel launch
    counts, summed over every leg."""
    from analytics_zoo_tpu_torch.serving import MiniRedisServer
    legs, checks, held = {}, {}, {}
    launches = dict.fromkeys(FLASH_KERNELS, 0)
    srv = MiniRedisServer(port=0).start()
    try:
        for m in FLEET["workers"]:
            name = f"m{m}"
            spec = _fleet_spec(srv, f"odfleet{m}")
            report = os.path.join(root, f"od_fleet_{m}")
            before = _gpu_apps()
            out = os.path.join(root, f"od_fleet_{m}.npz")
            client, go = _start_client(
                _fleet_client, spec, fx["imgs"]["uint8"], out,
                FLEET["warm_per_worker"] * m, name)
            try:
                fleet, spawn_s = _start_fleet(fx["path"], spec, m, True,
                                              report)
            except BaseException:
                client.kill()
                raise
            try:
                pids = [p.pid for p in fleet._procs.values()]
                cpu0, t0 = time.process_time(), time.perf_counter()
                go.set()
                _join_client(client)
                parent_cpu_s = time.process_time() - cpu0
                client_wall_s = time.perf_counter() - t0
                apps = _gpu_apps()
                heartbeats = fleet.metrics()["per_worker"]
            finally:
                snap = fleet.stop(timeout_s=90)
            after = _gpu_apps()
            reports, metrics = _worker_reports(report)
            per, total = _worker_launches(report)
            for k in FLASH_KERNELS:
                launches[k] += total[k]
            res = np.load(out)
            lat = res["latency_s"] * 1e3
            legs[name] = {
                "workers": m, "requests": FLEET["requests"],
                "seconds": float(res["seconds"]),
                "records_per_s": FLEET["requests"] / float(res["seconds"]),
                "request_latency_ms": {
                    "p50": float(np.percentile(lat, 50)),
                    "p99": float(np.percentile(lat, 99)),
                    "max": float(lat.max())},
                "spawn_to_live_s": spawn_s,
                "client_wall_s": client_wall_s,
                "client_cpu_s": float(res["client_cpu_s"]),
                "parent_cpu_s": parent_cpu_s,
                "heartbeats": heartbeats,
                "worker_stages": _stage_summary(metrics),
                "records_sent": FLEET["requests"]
                + FLEET["warm_per_worker"] * m,
                "records_out_total": snap["records_out_total"],
                "restarts": snap["restarts"],
                "worker_pids": pids, "parent_pid": os.getpid(),
                "nvidia_smi_apps_before": before, "nvidia_smi_apps": apps,
                "nvidia_smi_apps_after": after,
                "worker_reports": list(reports.values()),
                "worker_launches": per}
            checks[f"{name}_every_worker_reported_launches"] = \
                set(per) == set(pids)
            checks[f"{name}_all_answers_ok"] = _od_answers_ok(
                res["answers"], OD["max_det"], fx["num_classes"]) == 0
            checks[f"{name}_no_restarts"] = snap["restarts"] == 0
            checks.update(_on_card_checks(name, pids, reports, before,
                                          apps, after))
            held[name] = _held(res["answers"], fx["want"]["uint8"], name,
                               checks)
    finally:
        srv.stop()
    emit({"phase": "od_fleet",
          "config": {"ssd300": OD, "fleet": FLEET,
                     "broker": "MiniRedisServer (this process)"},
          "legs": legs, "held_against_predict": held,
          "limits": {"score": TOL_OD_SERVED_SCORE, "box": TOL_OD_SERVED_BOX},
          "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"the SSD300 fleet failed its checks: {checks}")
    return launches


def _get(port, path):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def http_fleet_phase(card, root, fx):
    """Two of the port's HTTP frontends in fleet mode (``worker_ttl_s``
    2.0) in front of a 2-worker SSD300 fleet whose workers trace
    (``ZOO_TRACE=1``, spans and final metrics to a ``trace_dir``). A
    client process, started beside the fleet and let go once it is live,
    sends FLEET["http_requests"] ``POST /predict`` with one f32 image as
    JSON each, alternately to the two doors; the answers
    are held as in ``od_fleet``. ``/readyz`` must be 200 with 2 live
    workers, ``/metrics`` must carry the ``fleet`` section,
    ``/metrics.prom`` must parse and hold ``zoo_fleet_workers_live`` and
    ``zoo_serving_http_events_total``, every worker that served must
    report its ``transfer`` section, and one request's trace id must run
    from a frontend's ``serving.request`` to a worker's
    ``serving.dispatch`` and ``serving.respond``. Returns the workers'
    own flash-kernel launch counts (the frontends run in this process)."""
    from analytics_zoo_tpu_torch.obs import trace
    from analytics_zoo_tpu_torch.obs.export import parse_exposition
    from analytics_zoo_tpu_torch.serving import MiniRedisServer
    from analytics_zoo_tpu_torch.serving.http_frontend import create_app
    checks = {}
    srv = MiniRedisServer(port=0).start()
    report = os.path.join(root, "http_fleet")
    try:
        spec = _fleet_spec(srv, "httpfleet")
        before = _gpu_apps()
        apps, fronts, fleet = [], [], None
        try:
            for _ in range(FLEET["frontends"]):
                app = create_app(spec, timeout_s=300.0, worker_ttl_s=2.0)
                fronts.append(app.start())
                apps.append(app)
            out = os.path.join(root, "http_fleet.npz")
            client, go = _start_client(_http_client, fronts,
                                       fx["imgs"]["f32"], out)
            try:
                fleet, spawn_s = _start_fleet(
                    fx["path"], spec, 2, False, report,
                    worker_env={"ZOO_TRACE": "1"})
            except BaseException:
                client.kill()
                raise
            with trace.tracing(capacity=65536):
                t0 = time.perf_counter()
                go.set()
                _join_client(client)
                seconds = time.perf_counter() - t0
                req_traces = {s.trace_id for s in trace.spans()
                              if s.name == "serving.request"}
            ready_status, ready = _get(fronts[0], "/readyz")
            metrics_status, metrics = _get(fronts[1], "/metrics")
            prom_status, prom = _get(fronts[0], "/metrics.prom")
            pids = [p.pid for p in fleet._procs.values()]
            gpu = _gpu_apps()
        finally:
            for app in apps:
                app.stop()
            if fleet is not None:
                snap = fleet.stop(timeout_s=90)
    finally:
        srv.stop()
    after = _gpu_apps()
    reports, worker_metrics = _worker_reports(report)
    per, launches = _worker_launches(report)
    ready, metrics = json.loads(ready), json.loads(metrics)
    samples = parse_exposition(prom.decode())
    chains = {}
    for name in os.listdir(report):
        if name.startswith("spans-"):
            with open(os.path.join(report, name)) as f:
                for line in f:
                    s = json.loads(line)
                    chains.setdefault(s["trace"], set()).add(s["name"])
    chained = [t for t in req_traces
               if {"serving.dispatch", "serving.respond"} <= chains.get(
                   t, set())]
    transfer = {wid: m.get("transfer") for wid, m in worker_metrics.items()}
    served = {wid: m.get("records_out", 0)
              for wid, m in worker_metrics.items()}
    res = np.load(out)
    checks.update({
        "readyz_200_two_workers": ready_status == 200
        and ready.get("workers_live") == 2,
        "metrics_fleet_section": metrics_status == 200
        and metrics.get("fleet", {}).get("workers_live") == 2
        and metrics.get("compile") == {},
        "prom_parses_with_fleet_and_http_series": prom_status == 200 and any(
            k.startswith("zoo_fleet_workers_live") for k in samples) and any(
            k.startswith("zoo_serving_http_events_total") for k in samples),
        "every_serving_worker_reports_transfer": sum(served.values())
        >= FLEET["http_requests"] and all(
            (transfer[w] or {}).get("h2d_bytes", 0) > 0
            for w, n in served.items() if n),
        "trace_crosses_processes": bool(chained),
        "all_answers_ok": _od_answers_ok(
            res["answers"], OD["max_det"], fx["num_classes"]) == 0,
        "no_restarts": snap["restarts"] == 0,
        "every_worker_reported_launches": set(per) == set(pids)})
    checks.update(_on_card_checks("http", pids, reports, before, gpu,
                                  after))
    held = _held(res["answers"], fx["want"]["f32"], "http", checks)
    lat = res["latency_s"] * 1e3
    emit({"phase": "http_fleet", "frontends": len(fronts), "workers": 2,
          "requests": FLEET["http_requests"], "seconds": seconds,
          "records_per_s": FLEET["http_requests"] / seconds,
          "request_latency_ms": {"p50": float(np.percentile(lat, 50)),
                                 "p99": float(np.percentile(lat, 99))},
          "spawn_to_live_s": spawn_s, "readyz": ready,
          "metrics_keys": sorted(metrics), "fleet": metrics.get("fleet"),
          "worker_transfer": transfer, "worker_records_out": served,
          "nvidia_smi_apps_before": before, "nvidia_smi_apps": gpu,
          "nvidia_smi_apps_after": after, "worker_pids": pids,
          "worker_stages": _stage_summary(worker_metrics),
          "trace_ids_requested": len(req_traces),
          "trace_ids_chained": len(chained), "worker_launches": per,
          "held_against_predict": held, "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"the HTTP fleet failed its checks: {checks}")
    return launches


def fleet_chaos_phase(card, root, fx):
    """The JAX bench's chaos leg on SSD300: two workers on the card over
    one stream (``claim_idle_ms`` 800), FLEET["requests"] uint8 requests
    enqueued at once, worker ``w0`` SIGKILLed (``kill_worker``) once its
    heartbeat shows it holding admitted requests. Every request must be
    answered (``lost == 0``), the survivor must have reclaimed the dead
    worker's claims (``reclaimed_total > 0``) and the supervisor must
    have respawned it (``restarts >= 1``); the answers are held as in
    ``od_fleet``. Returns the workers' own flash-kernel launch counts, the
    victim's as of its last finished predict."""
    from analytics_zoo_tpu_torch.serving import (InputQueue,
                                                 MiniRedisServer,
                                                 OutputQueue)
    from analytics_zoo_tpu_torch.serving.codecs import decode_payload
    checks = {}
    imgs = np.load(fx["imgs"]["uint8"])
    report = os.path.join(root, "chaos")
    srv = MiniRedisServer(port=0).start()
    try:
        spec = _fleet_spec(srv, "chaos")
        fleet, spawn_s = _start_fleet(fx["path"], spec, 2, True, report,
                                      heartbeat_s=0.1, poll_s=0.05)
        try:
            iq, oq = InputQueue(spec), OutputQueue(spec)
            uris = [iq.enqueue(f"chaos-{i}", t=imgs[i])
                    for i in range(len(imgs))]
            # the victim's heartbeat shows it holding admitted requests
            deadline = time.time() + 300
            while (fleet.metrics()["per_worker"].get("w0", {}).get(
                    "inflight", 0) == 0 and time.time() < deadline):
                time.sleep(0.02)
            at_kill = fleet.metrics()
            t_kill = time.perf_counter()
            killed = fleet.kill_worker("w0")
            answers, lost, errors = [], 0, 0
            for uri in uris:
                raw = oq.broker.get_result(uri, 600)
                if raw is None:
                    lost += 1
                    continue
                data, meta = decode_payload(raw)
                if meta.get("error"):
                    errors += 1
                    continue
                answers.append(data)
            recover_s = time.perf_counter() - t_kill
            deadline = time.time() + 300
            while fleet.metrics()["restarts"] < 1 and time.time() < deadline:
                time.sleep(0.1)
            # the respawn is up once it has loaded its model and written
            # its launch report (a heartbeat under the victim's id may be
            # the victim's last)
            deadline = time.time() + FLEET["live_timeout_s"]
            while (len(_worker_launches(report)[0])
                   < 2 + fleet.metrics()["restarts"]
                   and time.time() < deadline):
                time.sleep(0.1)
            respawn_live = fleet.wait_live(2, FLEET["live_timeout_s"])
        finally:
            snap = fleet.stop(timeout_s=90)
    finally:
        srv.stop()
    per, launches = _worker_launches(report)
    checks.update({
        "every_worker_reported_launches": len(per) == 2 + snap["restarts"],
        "killed_a_worker": killed == "w0",
        "killed_holding_requests": at_kill["per_worker"]["w0"][
            "inflight"] > 0,
        "lost_0": lost == 0, "errors_0": errors == 0,
        "reclaimed": snap["reclaimed_total"] > 0,
        "restarted": snap["restarts"] >= 1,
        "respawned_worker_live": respawn_live})
    held = None
    if len(answers) == len(imgs):
        held = _held(np.stack(answers), fx["want"]["uint8"], "chaos",
                     checks)
    else:
        checks["chaos_every_answer"] = False
    emit({"phase": "fleet_chaos", "requests": len(imgs), "killed": killed,
          "served_before_kill": at_kill["records_out_total"],
          "victim_inflight_at_kill": at_kill["per_worker"]["w0"]["inflight"],
          "lost": lost,
          "errors": errors, "seconds_kill_to_last_answer": recover_s,
          "reclaimed_total": snap["reclaimed_total"],
          "restarts": snap["restarts"], "spawn_to_live_s": spawn_s,
          "worker_launches": per,
          "held_against_predict": held, "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"the fleet's chaos leg failed its checks: {checks}")
    return launches


def _open_loop_leg(broker, record, rate_rps, n_req, deadline_s, seed,
                   n_fetchers=12):
    """One open-loop leg (the JAX bench's ``_serving_scale_leg``): Poisson
    arrivals at ``rate_rps``, an absolute deadline stamped at enqueue,
    latency from enqueue to the engine's ``t_done``. Returns ok, shed and
    lost counts, goodput and the admitted latency percentiles."""
    import queue
    import threading

    from analytics_zoo_tpu_torch.serving.codecs import (decode_payload,
                                                        encode_payload)
    results, lock = {}, threading.Lock()
    uri_q = queue.Queue()

    def fetch_loop():
        while True:
            item = uri_q.get()
            if item is None:
                return
            uri, t_enq, dl = item
            raw = broker.get_result(uri, max(dl - time.time(), 0.0) + 5.0)
            if raw is None:
                rec = ("lost", None)
            else:
                _, meta = decode_payload(raw)
                if meta.get("shed"):
                    rec = ("shed", None)
                elif meta.get("error"):
                    rec = ("error", None)
                else:
                    rec = ("ok", float(meta.get("t_done", time.time()))
                           - t_enq)
            with lock:
                results[uri] = rec

    fetchers = [threading.Thread(target=fetch_loop, daemon=True)
                for _ in range(n_fetchers)]
    for t in fetchers:
        t.start()
    gaps = np.random.RandomState(seed).exponential(1.0 / rate_rps, n_req)
    t0 = time.time()
    next_t = t0
    for i in range(n_req):
        next_t += gaps[i]
        delay = next_t - time.time()
        if delay > 0:
            time.sleep(delay)
        t_enq = time.time()
        uri = f"ol{seed}-{i}"
        broker.enqueue(uri, encode_payload(
            record, meta={"uri": uri, "deadline": t_enq + deadline_s}))
        uri_q.put((uri, t_enq, t_enq + deadline_s))
    for _ in fetchers:
        uri_q.put(None)
    for t in fetchers:
        t.join(timeout=120)
    wall = time.time() - t0
    counts = {"ok": 0, "shed": 0, "error": 0, "lost": 0}
    lats = []
    for kind, lat in results.values():
        counts[kind] += 1
        if lat is not None:
            lats.append(lat)
    lat = np.asarray(lats or [0.0]) * 1e3
    return {"requests": n_req, **counts,
            "goodput_rps": counts["ok"] / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)), "wall_s": wall}


def fleet_topology_phase(card, root):
    """The JAX bench's fleet legs 1-3 on ``SleepModel`` (host-only: it
    shows that the fleet, not the card, scales): ``batch_ms`` 100, batch
    4, so a worker serves 40 records/s by construction. One worker at 1.5x
    its capacity, two at 1.5x theirs: the two-worker goodput must reach
    TOPOLOGY["scaleout_min"] (1.5) x the one-worker goodput (the JAX
    smoke gate); its control, one worker at 10x, must miss it. Under 10x
    overload on one worker the admitted p99 must stay within the deadline
    + TOPOLOGY["p99_slack_ms"]; its control, the same worker at 10x with
    a deadline nothing reaches, must miss it. Returns the workers' own
    flash-kernel launch counts."""
    from analytics_zoo_tpu_torch.serving import (MiniRedisServer,
                                                 ServingFleet,
                                                 sleep_model_factory)
    from analytics_zoo_tpu_torch.serving.queue_api import make_broker
    t = TOPOLOGY
    cap1 = t["batch"] / (t["batch_ms"] / 1e3)
    vec = np.arange(64, dtype=np.float32)
    srv = MiniRedisServer(port=0).start()
    legs, spawned = {}, {}

    def run(stream, workers, legs_spec):
        spec = _fleet_spec(srv, stream)
        report = os.path.join(root, stream)
        os.makedirs(report, exist_ok=True)
        fleet = ServingFleet(
            partial(_counted_factory, report,
                    partial(sleep_model_factory, 2.0, t["batch_ms"])), spec,
            workers=workers, autoscale=False, batch_size=t["batch"],
            batch_timeout_ms=20.0, max_inflight=2 * t["batch"],
            heartbeat_s=0.25, worker_ttl_s=2.0, drain_s=10.0).start()
        broker = make_broker(spec)
        try:
            if not fleet.wait_live(workers, FLEET["live_timeout_s"]):
                fail(f"topology fleet {stream} never went live")
            for name, rate, dur, deadline, seed in legs_spec:
                legs[name] = _open_loop_leg(
                    broker, vec, rate, max(int(rate * dur), 2 * t["batch"]),
                    deadline, seed)
                legs[name]["workers"] = workers
        finally:
            snap = fleet.stop(timeout_s=30)
            broker.close()
        spawned[stream] = (workers + snap["restarts"],
                           _worker_launches(report))

    try:
        run("topo1", 1, [
            ("1w", 1.5 * cap1, t["dur_s"], t["deadline_s"], 201),
            ("10x_1w", 10 * cap1, t["over_dur_s"], t["over_deadline_s"],
             203),
            ("10x_1w_no_shed", 10 * cap1, t["control_dur_s"], 600.0, 205)])
        run("topo2", 2, [("2w", 3.0 * cap1, t["dur_s"], t["deadline_s"],
                          202)])
    finally:
        srv.stop()
    g1 = legs["1w"]["goodput_rps"]
    bound_ms = t["over_deadline_s"] * 1e3 + t["p99_slack_ms"]
    ratios = {"2w": legs["2w"]["goodput_rps"] / g1,
              "control_10x_1w": legs["10x_1w"]["goodput_rps"] / g1}
    checks = {
        "scaleout_at_least_1.5x": ratios["2w"] >= t["scaleout_min"],
        "control_one_worker_misses": ratios["control_10x_1w"]
        < t["scaleout_min"],
        "admitted_p99_bounded_10x": legs["10x_1w"]["p99_ms"] <= bound_ms,
        "control_no_shed_p99_misses": legs["10x_1w_no_shed"]["p99_ms"]
        > bound_ms,
        "overload_shed": legs["10x_1w"]["shed"] > 0,
        "none_lost": all(leg["lost"] == 0 for leg in legs.values()),
        "every_worker_reported_launches": all(
            len(per) == n for n, (per, _) in spawned.values())}
    emit({"phase": "fleet_topology", "config": t,
          "per_worker_capacity_rps": cap1, "legs": legs,
          "goodput_ratios": ratios, "p99_bound_ms": bound_ms,
          "worker_launches": {k: per for k, (_, (per, _)) in
                              spawned.items()},
          "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"the fleet topology failed its checks: {checks}")
    return {k: sum(total[k] for _, (_, total) in spawned.values())
            for k in FLASH_KERNELS}


# Runs ``python -m <module> <args>`` (``runpy`` as ``-m`` does) and, at
# exit, writes the process's flash-kernel launch counts to a file:
#   python -c _LAUNCH_PROBE <counts.json> <module> <args...>
_LAUNCH_PROBE = """\
import atexit, json, runpy, sys
out, module = sys.argv.pop(1), sys.argv.pop(1)
from analytics_zoo_tpu_torch.ops import attention as at


def write():
    with open(out, "w") as f:
        json.dump({fn.__name__: fn.launches for fn in
                   (at.flash_fwd, at.flash_bwd_dq, at.flash_bwd_dkv)}, f)


atexit.register(write)
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""


def obs_export_phase(card, root):
    """``python -m analytics_zoo_tpu_torch.obs perfetto --out <f>
    --demo-steps 8`` on the card (the demo fit resolves the card), run
    through ``_LAUNCH_PROBE`` so the process reports its own kernel
    launches: the file must be ``trace_event`` JSON with one step-indexed
    ``engine.dispatch`` span per step under the ``fit`` and ``epoch``
    spans. Returns the CLI process's flash-kernel launch counts."""
    out = os.path.join(root, "demo_trace.json")
    counts = os.path.join(root, "obs_launches.json")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _LAUNCH_PROBE, counts,
         "analytics_zoo_tpu_torch.obs", "perfetto",
         "--out", out, "--demo-steps", str(OBS_DEMO_STEPS)],
        cwd=here, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"obs perfetto exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(counts) as f:
        launches = json.load(f)
    with open(out, encoding="utf-8") as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    dispatch = sorted(e["args"]["step"] for e in spans
                      if e["name"] == "engine.dispatch")
    named = {e["tid"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    checks = {
        "exit_0": True,
        "phases_valid": all(e["ph"] in ("X", "M", "C") for e in events),
        "spans_well_formed": all(
            e["ts"] >= 0 and e["dur"] >= 0 and e["args"]["trace"]
            for e in spans),
        "dispatch_per_step": dispatch == list(range(OBS_DEMO_STEPS)),
        "fit_and_epoch": {"fit", "epoch"} <= {e["name"] for e in spans},
        "tracks_named": {e["tid"] for e in spans} <= named}
    emit({"phase": "obs_export", "seconds": seconds, "events": len(events),
          "span_names": sorted({e["name"] for e in spans}),
          "stdout": proc.stdout.strip()[-200:], "cli_launches": launches,
          "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"the Perfetto export failed its checks: {checks}")
    return launches


def inference_ride_alongs_phase(card):
    """``InferenceModel``'s slice-12 methods on the card: ``load_torch`` of
    a user's torch MLP served through ``ClusterServing`` answers as the
    module itself (f32, TF32 off, within TOL_LOAD_TORCH; the answers
    shifted by one row must miss); ``distributed_predict`` over 4-partition
    XShards equals ``predict`` of each partition bit for bit; and
    ``transfer_stats()`` counts exactly the bytes of the padded batches
    ``predict`` sent."""
    from analytics_zoo_tpu_torch.orca.data import XShards
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
        _bucket
    from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                                 InMemoryBroker, InputQueue,
                                                 OutputQueue)
    torch.manual_seed(0)
    module = torch.nn.Sequential(
        torch.nn.Linear(RIDE["features"], RIDE["hidden"]), torch.nn.ReLU(),
        torch.nn.Linear(RIDE["hidden"], RIDE["classes"]))
    model = InferenceModel().load_torch(module)
    x = np.random.RandomState(14).randn(
        RIDE["rows"], RIDE["features"]).astype(np.float32)
    with torch.inference_mode():
        own = module(torch.from_numpy(x).cuda()).cpu().numpy()
    broker = InMemoryBroker()
    serving = ClusterServing(model, queue=broker, batch_size=64).start(
        example=x[:1])
    try:
        iq, oq = InputQueue(broker), OutputQueue(broker)
        uris = [iq.enqueue(f"ride-{i}", t=x[i]) for i in range(len(x))]
        res = oq.dequeue(uris, timeout_s=120)
        transfer_section = serving.metrics().get("transfer")
    finally:
        serving.stop()
    served = np.stack([res[u] for u in uris])
    scale = float(np.abs(own).max())
    err = float(np.abs(served - own).max()) / scale
    control = float(np.abs(np.roll(served, 1, 0) - own).max()) / scale
    shards = XShards.partition({"x": x}, num_shards=4)
    parts = model.distributed_predict(shards).collect()
    dist_equal = len(parts) == 4 and all(
        np.array_equal(p["prediction"], model.predict(s["x"]))
        for p, s in zip(parts, shards.collect()))
    before = model.transfer_stats()["h2d_bytes"]
    sizes = (1, 5, 64, 100)
    for n in sizes:
        model.predict(x[:n])
    sent = model.transfer_stats()["h2d_bytes"] - before
    expect = sum(_bucket(n, model.buckets) for n in sizes) * x[0].nbytes
    checks = {
        "served_on_card": model.device.type == "cuda" and _on_card(module),
        "load_torch_served_as_module": err <= TOL_LOAD_TORCH,
        "load_torch_control_misses": control > TOL_LOAD_TORCH,
        "distributed_predict_equals_predict": dist_equal,
        "transfer_bytes_exact": sent == expect,
        "serving_metrics_transfer": bool(transfer_section)
        and transfer_section.get("h2d_bytes", 0) > 0}
    emit({"phase": "inference_ride_alongs", "config": RIDE,
          "load_torch_rel_err": err, "control_shifted_rel_err": control,
          "limit": TOL_LOAD_TORCH, "transfer_bytes": sent,
          "transfer_bytes_expected": expect, "transfer": transfer_section,
          "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"the InferenceModel ride-alongs failed their checks: {checks}")


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
                 slice_launches, late_paths=None):
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
    the ASHA slice's, the serving tier's, the fused-dispatch, TCMF's, the
    disk-tier FeatureSet's, the text and recommendation models' and the
    image paths (all 0 but the tiny BERT's fused fit, whose count is the
    profiler's record of the kernels on the card, graph replays
    included), and the TF-migration slice's (``tfpark_transformer_fit``
    and ``tfpark_vs_cpu`` launch each kernel on every block, the GAN and
    pipeline paths none). ``late_paths()`` runs after the timings and
    returns more paths' counts (the streaming slice's): after its threads
    and processes the profiler kept no device record of SDPA's backward
    in a whole smoke (a probe's 5-matmul session kept 10 records before
    the streaming phases and 5 after them; H100 80GB HBM3, 700 W)."""
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
    if late_paths is not None:
        slice_launches = {**slice_launches, **late_paths()}

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
        # what ran inside graph replays no wrapper sees: the card's records
        entry["launches_by_path_from"] = {
            "fused_tiny_bert": "torch.profiler device records of the fused "
                               "fit (it may drop records; "
                               "fused_tiny_bert's device_records_lost)",
            "other paths": "the wrapper's count"}
        out.append(entry)
    emit({"kernels": out})


def serving_tier_paths(card):
    """The serving tier's six phases, each driven with the flash kernels'
    counts at 0. A path's count is this process's plus those its other
    processes report of their own (fleet workers, the obs CLI); none may
    launch a flash kernel (their SSD300 holds no attention). Returns the
    counts by path."""
    from analytics_zoo_tpu_torch.ops import attention as at
    kernels = [getattr(at, name) for name in FLASH_KERNELS]
    root = tempfile.mkdtemp(prefix="fleet-")
    try:
        fx = fleet_fixture(root)
        launches = {}
        for name, run in (
                ("od_fleet", lambda: od_fleet_phase(card, root, fx)),
                ("http_fleet", lambda: http_fleet_phase(card, root, fx)),
                ("fleet_chaos", lambda: fleet_chaos_phase(card, root, fx)),
                ("fleet_topology", lambda: fleet_topology_phase(card, root)),
                ("obs_export", lambda: obs_export_phase(card, root)),
                ("inference_ride_alongs",
                 lambda: inference_ride_alongs_phase(card))):
            for fn in kernels:
                fn.launches = 0
            elsewhere = run() or {}
            launches[name] = {
                fn.__name__: fn.launches + elsewhere.get(fn.__name__, 0)
                for fn in kernels}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if any(n for counts in launches.values() for n in counts.values()):
        fail(f"a flash kernel launched on a serving-tier path: {launches}")
    return launches


# --- fused dispatch: k steps a CUDA-graph replay ----------------------------
# The fused_dispatch phase (ROADMAP A8a): the small-model paths through
# their users' entry points with config steps_per_dispatch "auto" (the k
# printed), then each at a fused k (the auto k, or FUSED["pin"] where auto
# keeps 1) and at 1, three runs from the same initial weights (fused,
# eager, eager again): a warm epoch, FUSED["epochs"] timed epochs (steady
# samples/s over their wall time) and one epoch under torch.profiler
# (device idle share). The fused run's final parameters are held against
# the first eager run's: bit for bit where the two eager runs agree bit
# for bit, else within TOL_GRAPH (see there). 2 timed epochs since the
# TF-migration slice (3 before), 1 since the streaming slice, to keep the
# whole smoke under 800 s.
FUSED = dict(epochs=1, pin=4, fraud_batch=16384, keras_rows=65536,
             keras_batch=4096, ncf_rows=8 * 65536, ncf_batch=65536,
             autots_batch=64)
# A 2-layer tiny BERT at pinned k = 4 (head size 64, so the flash kernels
# run), dropout 0.1, SGD with momentum: its captured train steps launch
# B1-B3.
TINY_BERT = dict(vocab=1000, hidden_size=128, n_block=2, n_head=2,
                 seq_len=128, intermediate_size=512, hidden_p_drop=0.1,
                 attn_p_drop=0.1)
TINY_BERT_RUN = dict(rows=512, batch=16, k=4, epochs=2, lr=0.05)
# Profiled sessions of graph replays alone after the tiny BERT's fused
# fit, of 1 and 2 epochs in turn. A session's records are a lower bound
# on what ran: in whole-smoke runs the profiler lost the first records of
# a session (H100 80GB HBM3, 700 W: one flash_fwd record, the first flash
# launch of the first replay, in each of three 1-epoch sessions in one
# run, in three of four sessions of another and in all six of a third;
# with one eager launch of each flash kernel 50 ms before the replays,
# those three records and the first replay's first embedding kernels in
# every session of a fourth; nothing in the phase run alone). So each
# session first launches REPLAY_PRIMER_LAUNCHES small kernels (no flash
# kernel), finishes them and waits REPLAY_PRIMER_PAUSE_S before the
# replays, and reports how many primer records it kept. No session may
# record more than its replays' captured launches, and at least one must
# record all of them.
REPLAY_SESSION_EPOCHS = (1, 2, 1, 2, 1, 2)
REPLAY_PRIMER_LAUNCHES = 1000
REPLAY_PRIMER_PAUSE_S = 0.5
# Graph vs eager where two eager runs already differ: the largest
# parameter difference relative to that parameter's largest entry. NCF's
# and BERT's embedding backward sums rows with index_add_ atomics, and
# cuDNN's conv weight gradient (the AutoTS TCN, TCMF's nets) sums in a
# varying order too; the other paths are held bit for bit. The control,
# the eager run with one more step (TCMF: epoch), must miss the limit.
# Readings (H100 80GB HBM3, 700 W): NCF eager vs eager 2.4e-7, graph vs
# eager 9.6e-8 / 2.4e-7, control 0.049; TCN 2.2e-7, 3.1e-7, control 0.013;
# tiny BERT (SGD, 64 steps) 2.7e-5, 1.2e-5, control 0.139; TCMF (10
# epochs, the hybrid off / on) 2.4e-7 / 2.7e-7 to 6.3e-7, 1.5e-7 / 2.0e-7
# to 2.8e-7, control 0.096 / 0.165. Under Adam
# the tiny BERT's two eager runs read 0.076 apart (Adam moves a
# parameter whose gradient is noise by ~lr whatever its sign), so the
# BERT check trains with SGD.
TOL_GRAPH = {"ncf": 1e-5, "autots_tcn": 1e-5, "tiny_bert": 1e-3,
             "tcmf": 1e-5}


def _max_param_rel(a, b):
    out = 0.0
    for name in a:
        x, y = a[name].double(), b[name].double()
        out = max(out, float((x - y).abs().max()
                             / y.abs().max().clamp_min(1e-30)))
    return out


def _fused_run(spec, k):
    """One run of a path at steps_per_dispatch ``k``: warm epoch, timed
    epochs, profiled epoch; samples/s, idle share, graph replays and the
    final parameters."""
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.orca.learn import graphs
    obj, est = spec["make"](k)
    before = dict(graphs.REPLAYS)
    spec["fit"](obj, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec["fit"](obj, FUSED["epochs"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        spec["fit"](obj, 1)
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t1) * 1e3
    busy = _busy_ms(_device_events(prof))
    params = {n: t.detach().clone()
              for n, t in est.module.state_dict().items()}
    evals = {}
    if k != 1:
        # evaluate at k twice (the first group of a signature is the
        # eager warm-up, later ones replay) and at 1: equal results
        before_eval = graphs.REPLAYS["eval"]
        fused = []
        for _ in range(2):
            fused.append(est.evaluate(spec["data"], batch_size=spec["batch"],
                                      verbose=False))
        eval_fuse = est.eval_fuse
        est.config["steps_per_dispatch"] = 1
        eager = est.evaluate(spec["data"], batch_size=spec["batch"],
                             verbose=False)
        evals = {"eval_fuse": eval_fuse, "fused": fused[1], "eager": eager,
                 "equal": fused[0] == fused[1] == eager,
                 "graph_replays": graphs.REPLAYS["eval"] - before_eval}
    else:
        # the control: one more (eager) step than the run
        spec["fit_steps"](obj, 1)
    return {"fuse": est.fuse, "evaluate": evals,
            "steps": est.engine.step,
            "graph_replays": graphs.REPLAYS["train"] - before["train"],
            "samples_per_s": spec["rows"] * FUSED["epochs"] / wall,
            "timed_wall_s": wall,
            "profiled_wall_ms": wall_p, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_p, "params": params,
            "control_params": {n: t.detach().clone()
                               for n, t in est.module.state_dict().items()}}


def _fused_path(name, spec, card):
    """The auto run, then fused / eager / eager: k, replays, rates, idle
    shares and the graph-vs-eager check."""
    obj, est = spec["make"]("auto")
    reason = est.engine.graph_gate()
    k_auto = spec["auto_fit"](obj, est)
    del obj, est
    # auto may pick the epoch's step count, which leaves no full group
    # when the tail is ragged (the JAX rule): the fused runs take as many
    # full batches as the epoch has
    full = spec["rows"] // spec["batch"]
    k = min(k_auto, full) if k_auto > 1 else FUSED["pin"]
    runs = {label: _fused_run(spec, kk)
            for label, kk in (("fused", k), ("eager", 1), ("eager2", 1))}
    ee = _max_param_rel(runs["eager2"]["params"], runs["eager"]["params"])
    ge = _max_param_rel(runs["fused"]["params"], runs["eager"]["params"])
    ctl = _max_param_rel(runs["fused"]["params"],
                         runs["eager"]["control_params"])
    if ee > 0.0 and name not in TOL_GRAPH:
        fail(f"two eager runs of {name} differ ({ee}): it is held bit "
             "for bit")
    limit = 0.0 if ee == 0.0 else TOL_GRAPH[name]
    out = {"path": name, "entry": spec["entry"], "k_auto": k_auto,
           "gate": reason, "k": k, "rows_per_epoch": spec["rows"],
           "eager_vs_eager_rel": ee, "graph_vs_eager_rel": ge,
           "graph_limit": limit, "control_one_more_step_rel": ctl,
           "graph_ok": ge <= limit < ctl
           and runs["fused"]["graph_replays"] > 0
           and runs["fused"]["evaluate"]["equal"]
           and runs["fused"]["evaluate"]["graph_replays"] > 0}
    for label, r in runs.items():
        out[label] = {key: v for key, v in r.items()
                      if key not in ("params", "control_params")}
    out["fused_over_eager_samples_per_s"] = (
        runs["fused"]["samples_per_s"] / runs["eager"]["samples_per_s"])
    return out


def _fraud_fused_spec():
    from analytics_zoo_tpu_torch.pipeline.nnframes import NNEstimator
    from analytics_zoo_tpu_torch.pipeline.nnframes.nn_classifier import \
        _col_to_array
    train, _ = _fraud_frames()
    x = _col_to_array(train, "features")
    y = _col_to_array(train, "label")
    batch = FUSED["fraud_batch"]

    def make(k):
        nn_est = (NNEstimator(_fraud_net().to_module(),
                              "binary_crossentropy")
                  .setBatchSize(batch).setMaxEpoch(1))
        make_est = nn_est._make_estimator

        def pinned():
            est = make_est()
            est.config["steps_per_dispatch"] = k
            return est
        nn_est._make_estimator = pinned
        est = pinned()
        return (nn_est, est), est

    def auto_fit(obj, _):
        # the user's call: NNEstimator.fit builds its own estimator
        return obj[0].fit(train).estimator.fuse

    def fit(obj, epochs, **kw):
        obj[1].fit({"x": x, "y": y}, epochs=epochs, batch_size=batch,
                   verbose=False, **kw)
    return {"make": make, "fit": fit, "auto_fit": auto_fit,
            "fit_steps": lambda o, n: fit(o, 1, steps_per_epoch=n),
            "rows": len(x), "batch": batch, "data": {"x": x, "y": y},
            "entry": "NNEstimator(net.to_module(), 'binary_crossentropy')"
                     ".setBatchSize(16384).fit(df); the NNModel's "
                     "estimator .fit for the timed runs"}


def _ncf_fused_spec():
    pairs, ratings = _ncf_data(FUSED["ncf_rows"])
    batch = FUSED["ncf_batch"]

    def make(k):
        model = _ncf_model(seed=0)
        model.estimator.config["steps_per_dispatch"] = k
        return model, model.estimator

    def fit(model, epochs, **kw):
        model.fit({"x": pairs, "y": ratings}, epochs=epochs,
                  batch_size=batch, verbose=False, **kw)
    return {"make": make, "fit": fit,
            "fit_steps": lambda m, n: fit(m, 1, steps_per_epoch=n),
            "auto_fit": lambda m, est: fit(m, 1) or est.fuse,
            "rows": len(pairs), "batch": batch,
            "data": {"x": pairs, "y": ratings},
            "entry": "NeuralCF(..., compute_dtype=bf16).compile(Adam)"
                     ".fit({'x', 'y'}, batch_size=65536)"}


def _autots_fused_spec(kind):
    from analytics_zoo_tpu_torch.zouwu.feature.time_sequence import \
        TimeSequenceFeatureTransformer
    from analytics_zoo_tpu_torch.zouwu.model import forecast as F
    tsft = TimeSequenceFeatureTransformer(horizon=1)
    x, y = tsft.fit_transform(_autots_frame(), past_seq_len=50)
    target = y if kind == "LSTM" else y[..., None]
    batch = FUSED["autots_batch"]

    def make(k):
        torch.manual_seed(0)
        if kind == "LSTM":
            f = F.LSTMForecaster(target_dim=1, feature_dim=x.shape[-1],
                                 lstm_units=(32, 16), dropouts=0.2,
                                 lr=1e-3)
        else:
            f = F.TCNForecaster(past_seq_len=50, future_seq_len=1,
                                input_feature_num=x.shape[-1],
                                output_feature_num=1,
                                num_channels=(16, 16, 16), kernel_size=3,
                                dropout=0.2, lr=1e-3)
        f.estimator.config["steps_per_dispatch"] = k
        return f, f.estimator

    def fit(f, epochs):
        f.fit(x, target, epochs=epochs, batch_size=batch)
    return {"make": make, "fit": fit,
            "fit_steps": lambda f, n: f.estimator.fit(
                {"x": x, "y": target}, epochs=1, batch_size=batch,
                steps_per_epoch=n, verbose=False),
            "auto_fit": lambda f, est: fit(f, 1) or est.fuse,
            "rows": len(x), "batch": batch, "data": {"x": x, "y": target},
            "entry": f"{kind}Forecaster(..., dropout 0.2).fit(x, y, "
                     f"batch_size={batch}) on the AutoTS windows"}


def _keras_fused_spec():
    x, y = synthetic_fraud(FUSED["keras_rows"], FRAUD["features"],
                           FRAUD["fraud_rate"], 1)
    batch = FUSED["keras_batch"]

    def make(k):
        net = _fraud_net(seed=0).compile("adam", "binary_crossentropy")
        net.estimator.config["steps_per_dispatch"] = k
        return net, net.estimator

    def fit(net, epochs, **kw):
        net.fit(x, y, batch_size=batch, nb_epoch=epochs, verbose=False,
                **kw)
    return {"make": make, "fit": fit,
            "fit_steps": lambda n_, n: fit(n_, 1, steps_per_epoch=n),
            "auto_fit": lambda n, est: fit(n, 1) or est.fuse,
            "rows": len(x), "batch": batch, "data": {"x": x, "y": y},
            "entry": "Sequential([Dense ...]).compile('adam', "
                     "'binary_crossentropy').fit(x, y, batch_size=4096)"}


def _device_flash_launches(prof):
    """Each flash kernel's device records in a torch.profiler session."""
    counts = dict.fromkeys(FLASH_KERNELS, 0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for n in FLASH_KERNELS:
                if f"{n}_kernel" in e.name:
                    counts[n] += 1
    return counts


def _prime_profiler():
    """REPLAY_PRIMER_LAUNCHES one-element float64 fills on the card (their
    records are FillFunctor<double>'s), finished, then a pause of
    REPLAY_PRIMER_PAUSE_S."""
    x = torch.empty(1, dtype=torch.float64, device="cuda")
    for i in range(REPLAY_PRIMER_LAUNCHES):
        x.fill_(i)
    torch.cuda.synchronize()
    time.sleep(REPLAY_PRIMER_PAUSE_S)


def _replay_session_records(prof, replays):
    """What a replay-only session's device records show beyond the flash
    counts: how many of the primer's launches the profiler kept, and every
    other kernel whose count is not a multiple of the replays."""
    names = collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    primer = sum(c for n, c in names.items()
                 if "FillFunctor<double>" in n)
    return {"primer_records": primer,
            "uneven_kernels": {n: c for n, c in names.items()
                               if replays and c % replays
                               and "FillFunctor<double>" not in n}}


def tiny_bert_fused_phase(card):
    """A 2-layer tiny BERT through BERTClassifier.fit at pinned k = 4 and
    at 1, from the same weights: the parameters match eager, and B1-B3 run
    inside the graph replays, as the card's own records show.

    The fused fit runs under torch.profiler: its launches are the device's
    records of the three kernels (the eager warm-up group's and those
    inside every replay), which the profiler may undercount (it drops
    records: 1 of 384 once on an H100 80GB HBM3 at 700 W). So they must
    exceed what the wrappers counted (the warm-up group's eager launches:
    the rest ran inside replays) and may not exceed the warm-up's plus the
    replays times what each capture recorded. Then profiled sessions of
    replays alone (REPLAY_SESSION_EPOCHS), each after its primer: the
    wrappers count none, no session records more than its replays'
    captured launches, and at least one session records all of them.
    Returns the fused fit's launches as the profiler read them."""
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.ops import attention as at
    from analytics_zoo_tpu_torch.orca.learn import graphs
    from analytics_zoo_tpu_torch.orca.learn.optimizers import SGD
    from analytics_zoo_tpu_torch.tfpark.text.estimator import \
        BERTClassifier
    cfg = TINY_BERT_RUN
    rng = np.random.RandomState(0)
    ids = rng.randint(1, TINY_BERT["vocab"],
                      (cfg["rows"], TINY_BERT["seq_len"])).astype(np.int32)
    labels = (ids[:, 0] % 2).astype(np.int32)
    data = {"x": ids, "y": labels}
    kernels = [getattr(at, n) for n in FLASH_KERNELS]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    runs, sessions = {}, []
    for label, k in (("fused", cfg["k"]), ("eager", 1), ("eager2", 1)):
        torch.manual_seed(0)
        est = BERTClassifier(num_classes=2, bert_config=TINY_BERT,
                             optimizer=SGD(learningrate=cfg["lr"],
                                           momentum=0.9))
        est.config["steps_per_dispatch"] = k
        for fn in kernels:
            fn.launches = 0
        before = graphs.REPLAYS["train"]
        with (profile(activities=acts) if label == "fused"
              else contextlib.nullcontext()) as prof:
            est.fit(data, epochs=cfg["epochs"], batch_size=cfg["batch"],
                    verbose=False)
            torch.cuda.synchronize()
        runs[label] = {
            "fuse": est.fuse, "steps": est.engine.step,
            "graph_replays": graphs.REPLAYS["train"] - before,
            "wrapper_launches": {fn.__name__: fn.launches
                                 for fn in kernels},
            "captured_launches": {
                fn.__name__: n for g in est.engine._graphs.values()
                for fn, n in g.launches.items()},
            "params": {n: t.detach().clone()
                       for n, t in est.module.state_dict().items()}}
        if label == "fused":
            runs[label]["device_launches"] = _device_flash_launches(prof)
            for epochs in REPLAY_SESSION_EPOCHS:
                for fn in kernels:
                    fn.launches = 0
                before = graphs.REPLAYS["train"]
                with profile(activities=acts) as prof:
                    _prime_profiler()
                    est.fit(data, epochs=epochs, batch_size=cfg["batch"],
                            verbose=False)
                    torch.cuda.synchronize()
                replays = graphs.REPLAYS["train"] - before
                sessions.append({
                    "graph_replays": replays,
                    "wrapper_launches": {fn.__name__: fn.launches
                                         for fn in kernels},
                    "device_launches": _device_flash_launches(prof),
                    **_replay_session_records(prof, replays)})
        if label == "eager":        # the control: one more step
            est.fit(data, epochs=1, batch_size=cfg["batch"],
                    steps_per_epoch=1, verbose=False)
            runs[label]["control_params"] = {
                n: t.detach().clone()
                for n, t in est.module.state_dict().items()}
    ee = _max_param_rel(runs["eager2"]["params"], runs["eager"]["params"])
    ge = _max_param_rel(runs["fused"]["params"], runs["eager"]["params"])
    ctl = _max_param_rel(runs["fused"]["params"],
                         runs["eager"]["control_params"])
    limit = 0.0 if ee == 0.0 else TOL_GRAPH["tiny_bert"]
    fused = runs["fused"]
    measured, eager_part = fused["device_launches"], fused["wrapper_launches"]
    captured = fused["captured_launches"]
    from_capture = {n: eager_part[n] + fused["graph_replays"]
                    * captured.get(n, 0) for n in FLASH_KERNELS}

    def complete(x):
        return {n: x["device_launches"][n] == x["graph_replays"]
                * captured.get(n, 0) for n in FLASH_KERNELS}

    checks = {
        "graph_replays": fused["graph_replays"] > 0,
        "kernels_in_graph": all(captured.get(n, 0) > 0
                                for n in FLASH_KERNELS),
        "expected_as_eager": from_capture == runs["eager"]["wrapper_launches"],
        "device_launches_in_replays": all(
            eager_part[n] < measured[n] <= from_capture[n]
            for n in FLASH_KERNELS),
        "replay_sessions_launch_nothing_eagerly": all(
            not any(x["wrapper_launches"].values()) for x in sessions),
        "replay_sessions_record_no_extra_launch": all(
            x["device_launches"][n] <= x["graph_replays"]
            * captured.get(n, 0) for x in sessions for n in FLASH_KERNELS),
        "a_replay_session_records_every_launch": any(
            x["graph_replays"] > 0 and all(complete(x).values())
            for x in sessions),
        "graph_matches_eager": ge <= limit < ctl}
    emit({"phase": "fused_tiny_bert", "config": TINY_BERT, **cfg,
          "eager_vs_eager_rel": ee, "graph_vs_eager_rel": ge,
          "graph_limit": limit, "control_one_more_step_rel": ctl,
          "launches_from_capture": from_capture,
          "device_records_lost": {n: from_capture[n] - measured[n]
                                  for n in FLASH_KERNELS},
          **{label: {key: v for key, v in r.items()
                     if key not in ("params", "control_params")}
             for label, r in runs.items()},
          "replay_sessions": sessions,
          "replay_sessions_complete": [complete(x) for x in sessions],
          "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"tiny BERT fused steps failed their checks: {checks}")
    return measured


def fused_dispatch_phase(card):
    """Each small-model path with the flash kernels' counts at 0 (none may
    launch one), then the tiny BERT, whose graphs must. Returns the counts
    by path."""
    from analytics_zoo_tpu_torch.ops import attention as at
    kernels = [getattr(at, n) for n in FLASH_KERNELS]
    launches, results = {}, []
    for name, make_spec in (("fraud", _fraud_fused_spec),
                            ("ncf", _ncf_fused_spec),
                            ("autots_lstm",
                             lambda: _autots_fused_spec("LSTM")),
                            ("autots_tcn", lambda: _autots_fused_spec("TCN")),
                            ("keras", _keras_fused_spec)):
        for fn in kernels:
            fn.launches = 0
        res = _fused_path(name, make_spec(), card)
        launches[f"fused_{name}"] = {fn.__name__: fn.launches
                                     for fn in kernels}
        emit({"phase": "fused_dispatch", **res, "card": card})
        results.append(res)
        torch.cuda.empty_cache()
    bad = [r["path"] for r in results if not r["graph_ok"]]
    if bad:
        fail(f"fused dispatch failed its graph checks on {bad}")
    if any(n for counts in launches.values() for n in counts.values()):
        fail(f"a flash kernel launched on a small-model path: {launches}")
    for fn in kernels:
        fn.launches = 0
    launches["fused_tiny_bert"] = tiny_bert_fused_phase(card)
    return launches


# --- TCMF and the disk-tier FeatureSet ---------------------------------------
# TCMF (ROADMAP A5b) at TCMFForecaster's defaults (rank 64,
# num_channels_X (32, 32), num_channels_Y (16, 16), kernel 7 clamped to 5,
# lr 5e-4 raised to 1e-3) with seasonal_period 24, on a seeded synthetic
# panel of the shape of DeepGLO's electricity panel (Sen, Yu & Dhillon,
# NeurIPS 2019: 370 series x 25,968 hourly steps; the real panel is not in
# the repository): per-series levels, a rank-4 daily (24) and weekly (168)
# seasonal structure and per-series AR(0.8) noise. 100 epochs (the
# default), so the "auto" gate turns the hybrid on (370 x 25,954 windows,
# strided to ~200,000), then predict(24).
TCMF_PANEL = dict(n=370, T=25968, horizon=24, seasonal_period=24,
                  epochs=100, profile_epochs=20, seed=0)
# Card against CPU, from the same seeded initial draws (drawn on the CPU
# and moved): TCMF(rank 8, seasonal_period 24), n 48, T 600, 10 epochs,
# the hybrid on and off, predict(8); with the hybrid, fit_incremental on
# the next 24 columns (5 epochs) too.
TCMF_SMALL = dict(n=48, T=600, rank=8, epochs=10, horizon=8,
                  seasonal_period=24, incremental=24)
# Limits, relative to the largest magnitude compared (per leaf for the
# nets): F, X, the TCN and the predictions; the local net, whose zero head
# makes its TCN's first gradients exactly zero and the next ones tiny, so
# Adam amplifies f32 rounding (on the CPU the port against JAX read 5.3e-4
# after 8 epochs, tests/test_torch_tcmf.py). The control, the card's fit
# with one more epoch, must miss each limit. Readings (H100 80GB HBM3,
# 700 W, three runs): F, X, TCN 8.2e-6 (control 0.096); predict 1.9e-7
# global-only (control 1.4e-3), 3.0e-6 to 2.6e-5 with the hybrid (control
# 0.037); the local net 3.8e-4 to 4.4e-4 (control 0.165).
TOL_TCMF = {"global": 1e-4, "local": 1e-2, "predict": 1e-4}
# fit_incremental starts from the card's and the CPU's fitted models,
# which already differ as above: its X read 4.9e-5 and its predict 6.0e-5
# (control, 6 epochs against 5: 9.0e-4 and 7.6e-4)
TOL_TCMF_INCREMENTAL = 2.5e-4
# a forecaster saved on the card and loaded on the CPU: one forward
# rollout on each device. Read 5.3e-7 and 6.9e-7 (H100 80GB HBM3, 700 W);
# the control, the card's fit with one more epoch, reads 0.037 against
# the saved model's predictions.
TOL_TCMF_LOAD = 1e-5
# Two f32 NCF steps over the disk stream, card against CPU: the losses'
# largest relative difference. At these seeded weights the loss sits near
# ln 5 whatever the batch holds, so a stream of another seed (the control)
# moves it by only 3.26e-6, against 7.4e-8 card vs CPU (H100 80GB HBM3,
# 700 W): the limit sits between them. The rows themselves are held bit
# for bit (the epoch through the pinned ring against the host stream).
TOL_FEATURESET_LOSS = 1e-6
# The same two steps' parameter updates, card against CPU: per leaf, the
# Frobenius norm of the difference of the two updates over the CPU's
# update. Adam's first step moves each touched entry by +-lr whatever its
# gradient's size, so a wrong row or a wrong update rule moves this
# measure by a whole entry's step, and the largest entry's difference
# would not do: one entry whose summed gradient changes sign card against
# CPU (the cotangents are rounded to bf16) moves it as far as another
# stream does. Read 5.4e-5 (item table; the largest entry there 1.1e-3),
# control (the stream of seed 1) 1.19 to 1.59 by leaf (H100 80GB HBM3,
# 700 W).
TOL_FEATURESET_UPDATE = 1e-2
# the NCF flagship through TPUEstimator.fit over a disk-tier FeatureSet
# and over the DRAM tier, from the same weights: MovieLens-1M's 1,000,209
# ratings (bench_ncf's synthetic pairs at its counts)
FEATURESET = dict(rows=1_000_209, shard_size=65536, batch=65536, epochs=2,
                  cpu_batch=NCF_CPU_BATCH, tfrecord_rows=4096,
                  tfrecord_batch=1024)


def _tcmf_panel(n, length, seed=0):
    """Per-series levels, a rank-4 daily and weekly seasonal structure and
    per-series AR(0.8) noise (innovations 0.3): f32 (n, length)."""
    rng = np.random.RandomState(seed)
    t = np.arange(length)
    basis = np.stack([f(2 * np.pi * t / p) for p in (24, 168)
                      for f in (np.sin, np.cos)])
    level = 5.0 + 10.0 * rng.rand(n, 1)
    y = level + rng.randn(n, 4) @ basis
    e = 0.3 * rng.randn(n, length)
    idio = np.zeros(n)
    for k in range(length):
        idio = 0.8 * idio + e[:, k]
        y[:, k] += idio
    return y.astype(np.float32)


def _tcmf_epoch_gflop(m, n, length):
    """Forward GFLOP of one global epoch (the TCN over the T - w windows of
    w steps, the rollout, F @ X) and of one local epoch (the local TCN over
    its windows and rollout), from the shapes; a backward is about twice."""
    def tcn_macs(c_in, channels, k):
        macs, c = 0, c_in
        for ch in channels:
            macs += k * c * ch + (c * ch if c != ch else 0)
            c = ch
        return macs
    w = m.window
    per_win = w * tcn_macs(m.rank, m.tcn_channels, m.kernel_size) \
        + m.tcn_channels[-1] * m.rank
    span = length - w - m.rollout_steps
    roll = len(range(0, span, max(1, span // 16))) * m.rollout_steps
    glob = (length - w + roll) * per_win + n * m.rank * length
    lw = m.local_window
    n_ch = 4 if m.seasonal_period else 2
    per_lwin = lw * tcn_macs(n_ch, m.local_channels, m.local_kernel_size) \
        + m.local_channels[-1]
    windows = n * len(range(0, length - lw, max(1, (length - lw) * n
                                                // 200_000)))
    h = min(m.rollout_steps, max(1, (length - lw) // 4))
    lspan = length - lw - h
    lroll = n * len(range(0, lspan, max(1, lspan // 16))) * h
    return {"global": 2e-9 * glob, "local": 2e-9 * (windows + lroll)
            * per_lwin, "local_windows": windows}


def _timed_fit(fc, y, epochs):
    """``fc.fit`` with the global and local phases timed apart: the fit
    reads the global loss (a sync) before it enters ``_fit_local``, which
    returns after reading its own."""
    m = fc.model
    marks = {}
    inner = m._fit_local

    def local(yn, ep):
        marks["global_end"] = time.perf_counter()
        try:
            return inner(yn, ep)
        finally:
            marks["local_end"] = time.perf_counter()
    m._fit_local = local
    try:
        t0 = time.perf_counter()
        out = fc.fit({"y": y}, epochs=epochs)
        t1 = time.perf_counter()
    finally:
        del m._fit_local
    end = marks.get("global_end", t1)
    return out, {"global_s": end - t0,
                 "local_s": marks.get("local_end", end) - end,
                 "fit_s": t1 - t0}


def tcmf_fit_phase(card):
    """TCMFForecaster's defaults on the 370 x 25,968 panel: after a 2-epoch
    warm-up fit, 100 epochs by graph replay with the hybrid on, then
    predict(24): phase seconds and epochs/s, captures and replays, peak
    memory above what earlier phases hold, predict ms, the forecast
    against the per-series mean and the last day; then a profiled fit of
    TCMF_PANEL["profile_epochs"] epochs: the device's idle share and its
    ten longest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.orca.learn import graphs
    from analytics_zoo_tpu_torch.zouwu.model.tcmf import TCMFForecaster
    cfg = TCMF_PANEL
    y = _tcmf_panel(cfg["n"], cfg["T"], cfg["seed"])
    h = cfg["horizon"]
    train, truth = y[:, :-h], y[:, -h:]
    # a warm-up fit of 2 epochs takes the process's first cuDNN, cuBLAS
    # and graph set-up out of the timed one
    t0 = time.perf_counter()
    TCMFForecaster(seasonal_period=cfg["seasonal_period"]).fit(
        {"y": train}, epochs=2)
    warmup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # what earlier phases still hold
    before = dict(graphs.CAPTURES), dict(graphs.REPLAYS)
    fc = TCMFForecaster(seasonal_period=cfg["seasonal_period"])
    out, times = _timed_fit(fc, train, cfg["epochs"])
    captures = graphs.CAPTURES["tcmf"] - before[0]["tcmf"]
    replays = graphs.REPLAYS["tcmf"] - before[1]["tcmf"]
    t0 = time.perf_counter()
    pred = fc.predict(h)
    predict_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - held
    m = fc.model
    work = _tcmf_epoch_gflop(m, cfg["n"], cfg["T"] - h)
    mse = {"model": float(np.mean((pred - truth) ** 2)),
           "mean": float(np.mean((train.mean(1, keepdims=True) - truth)
                                 ** 2)),
           "last_day": float(np.mean((train[:, -24:] - truth) ** 2))}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        TCMFForecaster(seasonal_period=cfg["seasonal_period"]).fit(
            {"y": train}, epochs=cfg["profile_epochs"])
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t1) * 1e3
    events = _device_events(prof)
    busy = _busy_ms(events)
    by_name = {}
    for e in events:
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start)
                           / 1e3, calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    checks = {
        "hybrid_on": m.ynet is not None and "local_loss" in out,
        "graph_captures": captures == 2,
        "graph_replays": replays == 2 * (cfg["epochs"] - 1),
        "finite": bool(np.isfinite(pred).all())
        and all(math.isfinite(v) for v in out.values()),
        "shape": pred.shape == (cfg["n"], h),
        "beats_mean": mse["model"] < mse["mean"],
        "device_time_seen": bool(events)}
    emit({"phase": "tcmf_fit", "entry": "TCMFForecaster(seasonal_period="
          "24).fit({'y': y}, epochs=100); predict(24)",
          "panel": {"n": cfg["n"], "T": cfg["T"] - h, "source":
                    "synthetic, DeepGLO electricity's shape"},
          "config": {"rank": m.rank, "tcn_channels": m.tcn_channels,
                     "kernel_size": m.kernel_size, "window": m.window,
                     "local_channels": m.local_channels,
                     "local_kernel_size": m.local_kernel_size,
                     "local_window": m.local_window, "lr": m.lr},
          "losses": out, "warmup_fit_s": warmup_s, **times,
          "global_epochs_per_s": cfg["epochs"] / times["global_s"],
          "local_epochs_per_s": (cfg["epochs"] / times["local_s"]
                                 if times["local_s"] else None),
          "epoch_gflop_forward": work,
          "global_gflop_per_s_fwd_bwd": 3 * work["global"] * cfg["epochs"]
          / times["global_s"],
          "graph_captures": captures, "graph_replays": replays,
          "peak_memory_gib": peak / 2 ** 30,
          "held_before_gib": held / 2 ** 30, "predict_ms": predict_ms,
          "forecast_mse": mse,
          "profiled_fit": {"epochs": cfg["profile_epochs"],
                           "wall_ms": wall_p, "device_busy_ms": busy,
                           "device_idle_share": 1.0 - busy / wall_p,
                           "top_kernels_ms_calls": [
                               [name[:90], ms, calls]
                               for name, (ms, calls) in top]},
          "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"tcmf_fit failed its checks: {checks}")


def _tcmf_small_fit(dev, local, epochs, eager=False):
    """TCMF_SMALL's fit on ``dev`` (epochs by graph replay on the card
    unless ``eager``): its F, X, nets and predict(horizon) on the CPU, and
    the model."""
    from analytics_zoo_tpu_torch.zouwu.model import tcmf
    cfg = TCMF_SMALL
    y = _tcmf_panel(cfg["n"], cfg["T"] + cfg["incremental"], seed=1)
    y = y[:, :cfg["T"]]
    m = tcmf.TCMF(rank=cfg["rank"], local_model=local,
                  seasonal_period=cfg["seasonal_period"], device=dev)
    with (tcmf._eager_epochs() if eager else contextlib.nullcontext()):
        out = m.fit(y, epochs=epochs)
    run = {"F": m.F.cpu(), "X": m.X.cpu(),
           "net": {k: v.cpu() for k, v in m.net.state_dict().items()},
           "predict": torch.from_numpy(m.predict(cfg["horizon"])),
           "losses": out}
    if m.ynet is not None:
        run["ynet"] = {k: v.cpu() for k, v in m.ynet.state_dict().items()}
    return run, m


def _tcmf_readings(run, ref):
    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    out = {"global": max([rel(run["F"], ref["F"]), rel(run["X"], ref["X"])]
                         + [rel(run["net"][k], ref["net"][k])
                            for k in ref["net"]]),
           "predict": rel(run["predict"], ref["predict"])}
    if "ynet" in ref:
        out["local"] = max(rel(run["ynet"][k], ref["ynet"][k])
                           for k in ref["ynet"])
    return out


def _tcmf_incremental(card_model, cpu_model):
    """``fit_incremental`` (5 epochs, by graph replay on the card) on the
    TCMF_SMALL panel's next columns from the card's and the CPU's fitted
    hybrids: the extended X and predict(horizon) held to
    TOL_TCMF_INCREMENTAL, the card's run with 6 epochs the control. The
    fitted models are left as they were (each run works on a shallow
    copy)."""
    cfg = TCMF_SMALL
    y_new = _tcmf_panel(cfg["n"], cfg["T"] + cfg["incremental"],
                        seed=1)[:, cfg["T"]:]
    runs = {}
    for name, model, epochs in (("card", card_model, 5),
                                ("cpu", cpu_model, 5),
                                ("control", card_model, 6)):
        m = copy.copy(model)
        out = m.fit_incremental(y_new, epochs=epochs)
        runs[name] = {"X": m.X.cpu(), "loss": out["train_loss"],
                      "predict": torch.from_numpy(m.predict(cfg["horizon"])),
                      "T_fit": m._T_fit}

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max())
    got = {"global": rel(runs["card"]["X"], runs["cpu"]["X"]),
           "predict": rel(runs["card"]["predict"], runs["cpu"]["predict"])}
    control = {"global": rel(runs["control"]["X"], runs["cpu"]["X"]),
               "predict": rel(runs["control"]["predict"],
                              runs["cpu"]["predict"])}
    return {"readings": got, "control_readings": control,
            "losses": {k: v["loss"] for k, v in runs.items()},
            "T_fit": runs["card"]["T_fit"],
            "limit": TOL_TCMF_INCREMENTAL,
            "ok": all(got[k] <= TOL_TCMF_INCREMENTAL < control[k]
                      for k in got)
            and runs["card"]["T_fit"] == cfg["T"] + cfg["incremental"]}


def tcmf_vs_cpu_phase(card):
    """TCMF_SMALL on the card and on the CPU from the same initial draws,
    the hybrid off and on: F, X, the nets and predict(8) held to TOL_TCMF,
    the card's fit with one more epoch the control that must miss every
    limit. Then graph replay against the eager loop on the card: bit for
    bit where two eager runs agree, else within TOL_GRAPH["tcmf"] (cuDNN's
    conv weight gradient may sum in a varying order), with the same
    control; and the hybrid's ``fit_incremental`` card vs CPU. Returns the
    hybrid card model and its one-more-epoch control."""
    cfg = TCMF_SMALL
    result, failed, keep = {}, [], None
    t0 = time.perf_counter()
    for local in (False, True):
        card_run, model = _tcmf_small_fit("cuda", local, cfg["epochs"])
        cpu_run, cpu_model = _tcmf_small_fit("cpu", local, cfg["epochs"])
        control_run, control_model = _tcmf_small_fit("cuda", local,
                                                     cfg["epochs"] + 1)
        eager, _ = _tcmf_small_fit("cuda", local, cfg["epochs"], eager=True)
        eager2, _ = _tcmf_small_fit("cuda", local, cfg["epochs"],
                                    eager=True)
        got = _tcmf_readings(card_run, cpu_run)
        control = _tcmf_readings(control_run, cpu_run)
        ee = max(_tcmf_readings(eager2, eager).values())
        ge = max(_tcmf_readings(card_run, eager).values())
        ctl_g = max(_tcmf_readings(control_run, eager).values())
        limit = 0.0 if ee == 0.0 else TOL_GRAPH["tcmf"]
        ok = (all(got[k] <= TOL_TCMF[k] < control[k] for k in got)
              and ge <= limit < ctl_g)
        name = "hybrid" if local else "global"
        if local:
            inc = _tcmf_incremental(model, cpu_model)
            ok = ok and inc["ok"]
            result["incremental"] = inc
        result[name] = {"readings": got, "control_readings": control,
                        "losses_card": card_run["losses"],
                        "losses_cpu": cpu_run["losses"],
                        "eager_vs_eager_rel": ee, "graph_vs_eager_rel": ge,
                        "graph_limit": limit,
                        "graph_control_rel": ctl_g, "ok": ok}
        if not ok:
            failed.append(name)
        if local:
            keep = model, control_model
    emit({"phase": "tcmf_vs_cpu", **{k: v for k, v in cfg.items()},
          "limits": TOL_TCMF, **result,
          "control": "the card's fit with one more epoch",
          "run_s": time.perf_counter() - t0, "card": card})
    if failed:
        fail(f"TCMF on the card disagrees with the CPU or its eager run: "
             f"{failed}")
    return keep


def _nyc_taxi_panel():
    """tests/test_zouwu_real_data.py's panel: the normalised NYC-taxi
    series as (half-hour of day, day), 48 x ~76."""
    import pandas as pd
    here = os.path.dirname(os.path.abspath(__file__))
    v = pd.read_csv(os.path.join(here, "tests", "resources",
                                 "nyc_taxi_subset.csv"))["value"].to_numpy(
        np.float32)
    series = (v - float(v.mean())) / float(v.std())
    n_days = len(series) // 48
    return series[:n_days * 48].reshape(n_days, 48).T


def _long_panel():
    """tests/test_zouwu_real_data.py:118's long panel: 16 series x 600,
    four seasonal periods plus AR(0.8) idiosyncrasy."""
    rng = np.random.RandomState(0)
    n, length = 16, 600
    F = rng.randn(n, 4)
    t = np.arange(length)
    X = np.stack([np.sin(t / p * 2 * np.pi) for p in (8, 12, 16, 24)])
    idio = np.zeros((n, length), np.float32)
    e = 0.3 * rng.randn(n, length)
    for k in range(1, length):
        idio[:, k] = 0.8 * idio[:, k - 1] + e[:, k]
    return (F @ X + idio).astype(np.float32)


def _tcmf_gates(seed):
    """Both TCMF gates of tests/test_zouwu_real_data.py for one initial
    draw, on the card: the NYC-taxi panel (TCMFForecaster(rank=16), 400
    epochs, the hybrid off by "auto", the last 7 days against the mean,
    persistence and 1.25 x the last week) and the long panel (TCMF(rank 8,
    window 28, local window 14, rollout 4), 80 epochs, the hybrid against
    global-only and half the mean)."""
    from analytics_zoo_tpu_torch.zouwu.model.tcmf import TCMF, TCMFForecaster
    panel = _nyc_taxi_panel()
    h = 7
    train, truth = panel[:, :-h], panel[:, -h:]
    fc = TCMFForecaster(rank=16)
    fc.model.seed = seed
    fc.fit({"y": train}, epochs=400)
    pred = fc.predict(horizon=h)
    g1 = {"hybrid_off": fc.model.ynet is None,
          "model": float(np.mean((pred - truth) ** 2)),
          "mean": float(np.mean((train.mean(1, keepdims=True) - truth)
                                ** 2)),
          "persistence": float(np.mean((train[:, -1:] - truth) ** 2)),
          "last_week": float(np.mean((train[:, -h:] - truth) ** 2))}
    g1["pass"] = (g1["hybrid_off"] and g1["model"] < g1["mean"]
                  and g1["model"] < g1["persistence"]
                  and g1["model"] < 1.25 * g1["last_week"])
    y = _long_panel()
    h = 4
    train, truth = y[:, :-h], y[:, -h:]
    g2 = {"mean": float(np.mean((train.mean(1, keepdims=True) - truth)
                                ** 2))}
    for local in (False, True):
        m = TCMF(rank=8, window=28, local_model=local, local_window=14,
                 rollout_steps=h, seed=seed)
        m.fit(train, epochs=80)
        g2["hybrid" if local else "global_only"] = float(
            np.mean((m.predict(h) - truth) ** 2))
    g2["pass"] = (g2["hybrid"] < g2["global_only"]
                  and g2["hybrid"] < 0.5 * g2["mean"])
    return {"seed": seed, "nyc_taxi": g1, "long_panel": g2}


def tcmf_real_data_phase(card):
    """The two TCMF gates of tests/test_zouwu_real_data.py on the card
    (:75 the NYC-taxi panel, :109 the long panel) at the port's initial
    draw from seed 0, which the JAX tests hold at theirs; the draws of
    REAL_DATA_SEEDS are reported with their medians, not gated: on the
    CPU both packages miss the NYC-taxi gate at some draws (ROADMAP queue
    C)."""
    t0 = time.perf_counter()
    draws = [_tcmf_gates(seed) for seed in REAL_DATA_SEEDS]
    gate = draws[0]

    def med(gate_name, key):
        return statistics.median(d[gate_name][key] for d in draws)
    checks = {"nyc_taxi_seed0": gate["nyc_taxi"]["pass"],
              "long_panel_seed0": gate["long_panel"]["pass"]}
    emit({"phase": "tcmf_real_data", "gated_seed": gate["seed"],
          "draws": draws,
          "medians": {"nyc_taxi_model": med("nyc_taxi", "model"),
                      "long_panel_hybrid": med("long_panel", "hybrid"),
                      "long_panel_global_only": med("long_panel",
                                                    "global_only")},
          "passing_draws": {
              "nyc_taxi": sum(d["nyc_taxi"]["pass"] for d in draws),
              "long_panel": sum(d["long_panel"]["pass"] for d in draws)},
          "checks": checks, "run_s": time.perf_counter() - t0,
          "card": card})
    if not all(checks.values()):
        fail(f"the TCMF real-data gates failed on the card: {checks}")


def tcmf_save_load_phase(card, model, control):
    """The hybrid card model of tcmf_vs_cpu saved on the card, loaded on
    the card (predict bit for bit) and on the CPU (within TOL_TCMF_LOAD,
    which its one-more-epoch control must miss)."""
    from analytics_zoo_tpu_torch.zouwu.model.tcmf import TCMFForecaster
    h = TCMF_SMALL["horizon"]
    root = tempfile.mkdtemp(prefix="tcmf-")
    try:
        fc = TCMFForecaster.__new__(TCMFForecaster)
        fc.model = model
        path = os.path.join(root, "tcmf.pkl")
        fc.save(path)
        want = fc.predict(h)
        on_card = TCMFForecaster.load(path).predict(h)
        on_cpu = TCMFForecaster.load(path, device="cpu").predict(h)
        nbytes = os.path.getsize(path)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def rel(got):
        return float(np.abs(got - want).max() / np.abs(want).max())
    cpu_rel, control_rel = rel(on_cpu), rel(control.predict(h))
    checks = {"card_bitwise": bool(np.array_equal(on_card, want)),
              "cpu_within": cpu_rel <= TOL_TCMF_LOAD < control_rel,
              "hybrid": model.ynet is not None}
    emit({"phase": "tcmf_save_load", "blob_bytes": nbytes,
          "cpu_rel": cpu_rel, "control_rel": control_rel,
          "limit": TOL_TCMF_LOAD, "checks": checks, "card": card})
    if not all(checks.values()):
        fail(f"a saved TCMF does not predict as it did: {checks}")


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _featureset_two_steps(dev, cache, seed):
    """The f32 NCF, two epochs of one step each through TPUEstimator.fit
    over a DiskFeatureSet of ``cache`` at FEATURESET["cpu_batch"]: the two
    steps' losses, and the parameters before and after them on the CPU."""
    from analytics_zoo_tpu_torch.feature import DiskFeatureSet
    model = _ncf_model(dtype=torch.float32, seed=3, device=dev)

    def params():
        return {n: t.detach().cpu().clone()
                for n, t in model.module.state_dict().items()}
    start = params()
    fs = DiskFeatureSet(cache, None, FEATURESET["cpu_batch"], seed=seed)
    stats = model.estimator.fit(fs, epochs=2, batch_size=fs.global_bs,
                                steps_per_epoch=1, verbose=False)
    return [s["train_loss"] for s in stats], start, params()


def _update_rel(run, ref):
    """Per leaf, how far ``run``'s two steps moved the parameters from
    where ``ref``'s moved them, relative to ``ref``'s move (Frobenius
    norms), and the largest entry's difference relative to the leaf's
    largest entry (``_max_param_rel``'s measure)."""
    (_, start, got), (_, ref_start, want) = run, ref
    out = {}
    for name in want:
        a = (got[name] - start[name]).double()
        b = (want[name] - ref_start[name]).double()
        out[name] = {
            "update": float((a - b).norm() / b.norm().clamp_min(1e-30)),
            "max_entry": _max_param_rel({name: got[name]},
                                        {name: want[name]})}
    return out


def featureset_disk_fit_phase(card):
    """The NCF flagship (bf16) through TPUEstimator.fit over a disk-tier
    FeatureSet (MovieLens-1M's row count, shards of 65,536) and over the
    DRAM tier, 2 epochs each from the same weights, both unfused (the disk
    tier never fuses, as in the JAX package; the DRAM run is pinned to
    match): steady and epoch samples/s, the pipeline's stages, the cache's
    bytes and write seconds. Then the disk stream on the card against the
    CPU: an epoch through the pump and the pinned ring bit for bit, and 2
    f32 steps' losses within TOL_FEATURESET_LOSS and their parameter
    updates within TOL_FEATURESET_UPDATE (control: another seed's stream).
    Then a from_tfrecords FeatureSet trains one epoch."""
    from analytics_zoo_tpu_torch.feature import DiskFeatureSet, FeatureSet
    from analytics_zoo_tpu_torch.orca.data.tfrecord import write_tfrecords
    cfg = FEATURESET
    pairs, ratings = _ncf_data(cfg["rows"])
    data = {"x": pairs, "y": ratings}
    root = tempfile.mkdtemp(prefix="featureset-")
    t0 = time.perf_counter()
    try:
        cache = os.path.join(root, "cache")
        tw = time.perf_counter()
        disk = FeatureSet.from_arrays(data, tier="disk",
                                      batch_size=cfg["batch"],
                                      cache_dir=cache,
                                      shard_size=cfg["shard_size"])
        write_s = time.perf_counter() - tw
        dram = FeatureSet.from_arrays(data, tier="dram",
                                      batch_size=cfg["batch"])
        tiers = {}
        for name, it in (("disk", disk), ("dram", dram)):
            model = _ncf_model(seed=0)
            est = model.estimator
            est.config["steps_per_dispatch"] = 1
            stats = est.fit(it, epochs=cfg["epochs"],
                            batch_size=cfg["batch"], profile=True,
                            verbose=False)
            torch.cuda.synchronize()
            last = stats[-1]
            step_ms = last["profile"]["step_ms"]
            rows = last["profile"]["steps"] * cfg["batch"]
            tiers[name] = {
                "steps_per_epoch": it.steps_per_epoch, "fuse": est.fuse,
                "losses": [s["train_loss"] for s in stats],
                "steady_samples_per_s": cfg["batch"]
                / (statistics.median(step_ms[1:]) / 1e3),
                "epoch_samples_per_s": rows / last["time_s"],
                "pipeline": {k: v for k, v in
                             est.data_pipeline_stats().items()
                             if k.split("_")[0] in ("assemble", "h2d",
                                                    "stall", "step")
                             or k == "transfer_limited"}}
        ring = DiskFeatureSet(cache, None, cfg["cpu_batch"], seed=0)
        host = DiskFeatureSet(cache, None, cfg["cpu_batch"], seed=0)
        batches = ring.epoch()
        try:
            ring_bitwise = ring.steps_per_epoch > 0 and all(
                np.array_equal(t.cpu().numpy(), h)
                for got, want in zip(batches, host._host_batches(True))
                for t, h in zip(got.leaves(), list(want.x) + list(want.y)))
        finally:
            batches.close()
        card_run = _featureset_two_steps("cuda", cache, 0)
        cpu_run = _featureset_two_steps("cpu", cache, 0)
        control_run = _featureset_two_steps("cuda", cache, 1)
        card_losses, cpu_losses, control_losses = (
            card_run[0], cpu_run[0], control_run[0])
        params_rel = _update_rel(card_run, cpu_run)
        control_params_rel = _update_rel(control_run, cpu_run)

        def off(run):
            return max(abs(a - b) / abs(b) for a, b in zip(run, cpu_losses))

        def worst(rel):
            return max(v["update"] for v in rel.values())
        path = os.path.join(root, "ratings.tfrecord")
        n_tf = cfg["tfrecord_rows"]
        write_tfrecords(path, iter(
            {"pair": pairs[i].astype(np.int64),
             "rating": np.asarray([ratings[i]], np.int64)}
            for i in range(n_tf)))
        tf_set = FeatureSet.from_tfrecords(
            path, feature_cols=["pair"], label_cols=["rating"],
            tier="disk", batch_size=cfg["tfrecord_batch"],
            cache_dir=os.path.join(root, "tfcache"))
        tf_stats = _ncf_model(seed=0).estimator.fit(
            tf_set, epochs=1, batch_size=cfg["tfrecord_batch"],
            verbose=False)
        cache_bytes = _dir_bytes(cache)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    checks = {
        "disk_unfused": tiers["disk"]["fuse"] == 1,
        "finite": all(math.isfinite(v) for t in tiers.values()
                      for v in t["losses"]),
        "ring_batch_bitwise": ring_bitwise,
        "card_vs_cpu_losses": off(card_losses) <= TOL_FEATURESET_LOSS
        < off(control_losses),
        "card_vs_cpu_params": worst(params_rel) <= TOL_FEATURESET_UPDATE
        < min(v["update"] for v in control_params_rel.values()),
        "tfrecords_trained": tf_set.steps_per_epoch == n_tf
        // cfg["tfrecord_batch"]
        and math.isfinite(tf_stats[-1]["train_loss"])}
    emit({"phase": "featureset_disk_fit", "entry": "FeatureSet.from_arrays("
          "{'x', 'y'}, tier='disk', batch_size=65536) -> NeuralCF "
          "estimator.fit", **cfg, "cache_bytes": cache_bytes,
          "write_s": write_s, "tiers": tiers,
          "disk_over_dram_epoch_samples_per_s":
          tiers["disk"]["epoch_samples_per_s"]
          / tiers["dram"]["epoch_samples_per_s"],
          "losses_card": card_losses, "losses_cpu": cpu_losses,
          "losses_control": control_losses,
          "card_vs_cpu_rel": off(card_losses),
          "control_rel": off(control_losses),
          "limit": TOL_FEATURESET_LOSS,
          "params_card_vs_cpu": params_rel,
          "params_control": control_params_rel,
          "update_rel": worst(params_rel),
          "update_limit": TOL_FEATURESET_UPDATE,
          "tfrecords": {"rows": n_tf, "loss": tf_stats[-1]["train_loss"]},
          "checks": checks, "run_s": time.perf_counter() - t0,
          "card": card})
    if not all(checks.values()):
        fail(f"featureset_disk_fit failed its checks: {checks}")


def tcmf_featureset_paths(card):
    """TCMF's four phases and the disk-tier FeatureSet's, each path driven
    with the flash kernels' counts at 0 (neither reaches one). Returns the
    counts by path."""
    from analytics_zoo_tpu_torch.ops import attention as at
    kernels = [getattr(at, name) for name in FLASH_KERNELS]
    launches = {}

    def tcmf_path():
        tcmf_fit_phase(card)
        torch.cuda.empty_cache()
        tcmf_save_load_phase(card, *tcmf_vs_cpu_phase(card))
        tcmf_real_data_phase(card)
    for name, run in (("tcmf", tcmf_path),
                      ("featureset", lambda: featureset_disk_fit_phase(card))):
        for fn in kernels:
            fn.launches = 0
        run()
        launches[name] = {fn.__name__: fn.launches for fn in kernels}
        torch.cuda.empty_cache()
    if any(n for counts in launches.values() for n in counts.values()):
        fail(f"a flash kernel launched on a TCMF or FeatureSet path: "
             f"{launches}")
    return launches


# --- the model zoo's text, ranking, sequence and recommendation models ------
# news20 at the JAX TextClassifier's defaults, which are news20's widths:
# 20 classes, sequence 500, embed 200 (glove.6B.200d's width), the cnn
# encoder at 256, batch 128, sparse categorical cross-entropy, Adagrad at lr
# 0.01, word2idx(remove_topN=10, max_words_num=20000) (ids 1-20,000, a table
# of 20,001 rows), random_split([0.8, 0.2]). news20 and the GloVe vectors
# are not in the repository: the corpus is seeded and synthetic, in
# TextSet.read's layout (20 category folders of documents of 150-400
# tokens: 10,000 documents, news20's 19,997 cut by half since the streaming
# slice, whose phases needed the ~20 s of host stages the other half took,
# to keep the whole smoke under 800 s). Words come from a Zipf vocabulary of 24,000 words;
# each category over-weights 10 topic words of its own (a quarter of a
# document's tokens), drawn from the vocabulary's middle ranks. The GloVe
# file holds a seeded 200-d vector for every word.
NEWS20 = dict(classes=20, docs=10000, vocab=24000, topic_words=10,
              topic_share=0.25, min_len=150, max_len=400, seq=500, embed=200,
              filters=256, batch=128, epochs=2, lr=0.01, remove_top=10,
              max_words=20000, rnn_steps=16, seed=0)
# The holdout accuracy gate: chance is 1/20, and the untrained model (the
# control, the same model before fit) reads near it; a trained model that
# found the topic words clears 0.5 by a wide margin.
NEWS20_GATE = 0.5
# Card vs CPU at small widths (vocab 500, sequence 50, embed 16, batch 32):
# each model trains 3 steps through its user's fit on the card and on the
# CPU from the same weights (dropout 0), f32 with TF32 off (matmuls and
# cuDNN). Limits: every parameter leaf's largest difference relative to
# its largest entry at 3e-3 (Adam's steps normalise each gradient entry,
# so an entry whose gradient is near zero moves by the rounding of the
# two devices' sums: cuDNN's LSTM sums its 50 steps of backpropagation in
# another order than the CPU's, as zouwu_vs_cpu's TOL_STEP_GRAD says),
# and the predictions' largest difference relative to their largest
# magnitude at 4e-5. The control, the card with one more step (4), must
# miss both: two CPU runs of 3 and 4 steps read 0.25-0.34 on the
# parameters (biases start at zero and move by a third) and 1.4e-4
# (Seq2seq LSTM) to 3.0e-2 (NER) on the predictions. Readings on an H100
# 80GB HBM3 at 700 W over three runs: parameters 6.6e-6 (KNRM) to 3.0e-4
# (TextClassifier's lstm encoder, 8.6e-5 to 3.0e-4 over the runs; the
# Keras LSTM's cuDNN branch 1.2e-5 to 2.8e-4), predictions 1.2e-7 to
# 7.7e-6; controls at least 0.20 (parameters) and 2.9e-4 (KNRM's
# predictions).
TEXT_VS_CPU = dict(vocab=500, seq=50, embed=16, batch=32, steps=3,
                   classes=4, seed=0)
TOL_TEXT_VS_CPU = {"param": 3e-3, "pred": 4e-5}
# KNRM at WikiQA's widths (question 10, answer 40, embed 300, 21 kernels,
# sigma 0.1, exact sigma 0.001) over seeded relation pairs; Seq2seq (LSTM,
# hidden 128) on tests/test_models_zoo.py's reversal task with its gates;
# NER at its defaults (word 100, char 30, LSTM 100, 9 tags) and
# IntentEntity; a Keras LSTM (hard_sigmoid: the loop branch; sigmoid: one
# cuDNN call) at width 128 over 50 steps.
KNRM_WIKIQA = dict(q_len=10, a_len=40, embed=300, kernels=21, sigma=0.1,
                   exact_sigma=0.001, vocab=5000, questions=512,
                   answers_per_q=8, epochs=5, batch=64, lr=1e-2)
# KNRM's gate: a relevant answer shares 8 words with its question, so the
# exact-match kernel (mu 1.0) tells them apart once the ranker weighs it
# up; the untrained ranker's sign is a draw (per-question MAP 0.16 or 1.0
# on the CPU and the card). After training, MAP >= 0.8 over the training
# questions (0.81 on the CPU at half the questions, 60 steps).
KNRM_MAP_GATE = 0.8
S2S_REVERSAL = dict(vocab=12, seq=4, rows=1500, hidden=128, embed=16,
                    epochs=14, batch=128, infer_len=30)
TAGGERS = dict(vocab=5000, chars=60, sent=30, word_len=12, tags=9,
               intents=8, rows=1024, batch=64, steps=8)
KERAS_LSTM = dict(width=128, steps=50, batch=64, features=32, reps=20)
# Wide & Deep at MovieLens-1M's widths over bench_ncf's synthetic ratings
# (262,144 of its rows; the users' gender, age and occupation and the
# items' genres drawn from seed 0): wide base occupation (21) and gender
# (3) with the age x gender cross (100), indicators genres (19) and gender
# (3), embeddings userId 6,040 -> 64 and itemId 3,952 -> 64, continuous
# age, hidden (40, 20, 10), 2 classes (rating >= 3), batch 1,024.
WND = dict(rows=262144, users=6040, items=3952, batch=1024, epochs=1)
SESSION = dict(items=3952, session=5, history=10, rows=65536, batch=256,
               epochs=1)
ANOMALY = dict(unroll=24, hidden=(8, 32, 15), dropout=0.2, epochs=5,
               batch=256, anomalies=20)
# AnomalyDetector card vs CPU (dropout off, 3 Adam steps at batch 256 of
# the taxi windows), the control one more step: parameters as
# TEXT_VS_CPU; predictions at 1e-4 of their largest magnitude, since the
# head's outputs after 3 steps are small (reading 1.8e-5, control 0.47 on
# an H100 80GB HBM3 at 700 W).
TOL_ANOMALY_VS_CPU = {"param": TOL_TEXT_VS_CPU["param"], "pred": 1e-4}


def _zipf_words(n, rng):
    """``n`` distinct lower-case pseudo-words (tokenize and normalize keep
    them as they are)."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    out, seen = [], set()
    while len(out) < n:
        for w in ("".join(letters[rng.randint(0, 26, rng.randint(4, 9))])
                  for _ in range(n)):
            if w not in seen:
                seen.add(w)
                out.append(w)
    return out[:n]


def news20_corpus(root, cfg=NEWS20):
    """Writes the synthetic corpus in news20's layout under
    ``root/news20`` and a GloVe-format file ``root/glove.txt``; returns
    both paths and the token count."""
    rng = np.random.RandomState(cfg["seed"])
    words = np.array(_zipf_words(cfg["vocab"], rng))
    cdf = np.cumsum(1.0 / np.arange(1, cfg["vocab"] + 1))
    cdf /= cdf[-1]
    lengths = rng.randint(cfg["min_len"], cfg["max_len"] + 1, cfg["docs"])
    labels = np.arange(cfg["docs"]) % cfg["classes"]
    topic = rng.rand(lengths.sum()) < cfg["topic_share"]
    background = np.searchsorted(cdf, rng.rand(lengths.sum()))
    mid = 200 + rng.permutation(cfg["classes"] * cfg["topic_words"])
    topics = mid.reshape(cfg["classes"], cfg["topic_words"])
    doc_of = np.repeat(np.arange(cfg["docs"]), lengths)
    picks = topics[labels[doc_of], rng.randint(0, cfg["topic_words"],
                                               lengths.sum())]
    tokens = np.where(topic, picks, background).tolist()
    words = words.tolist()
    news = os.path.join(root, "news20")
    for c in range(cfg["classes"]):
        os.makedirs(os.path.join(news, f"group{c:02d}"))
    ends = np.cumsum(lengths).tolist()
    lens = lengths.tolist()

    def write(docs):
        for d in docs:
            end, n = ends[d], lens[d]
            with open(os.path.join(news, f"group{labels[d]:02d}", str(d)),
                      "w") as f:
                f.write(" ".join([words[i] for i in tokens[end - n:end]])
                        + ".\n")
    # creating 20,000 files dominates on the card's host and releases the
    # GIL: 8 writers took 9.0-11.3 s there against 15.6-22.6 s for one
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(write, np.array_split(np.arange(cfg["docs"]), 8)))
    vecs = rng.randn(cfg["vocab"], cfg["embed"]).astype(np.float32) * 0.4
    glove = os.path.join(root, "glove.txt")
    row = " ".join(["%.4f"] * cfg["embed"])
    with open(glove, "w") as f:
        f.writelines(w + " " + row % tuple(v) + "\n"
                     for w, v in zip(words, vecs.tolist()))
    return news, glove, int(lengths.sum())


def _fit_profile(fit):
    """``fit()`` under torch.profiler: device idle share over its wall
    time and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    if not events:
        fail("the profiler saw no device time in the profiled fit")
    by_kernel = {}
    for e in events:
        tot, k = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (tot + e.time_range.elapsed_us() / 1e3, k + 1)
    busy = _busy_ms(events)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "device_events": len(events),
            "top_kernels": [{"name": n[:120], "ms": v[0], "launches": v[1]}
                            for n, v in top]}


def _steady_rate(stats, batch):
    steps = [ms for s in stats for ms in s["profile"]["step_ms"]]
    tail = steps[len(steps) // 4:] or steps
    return batch / (statistics.median(tail) / 1e3), statistics.median(tail)


def text_classifier_news20_phase(card, root, dev="cuda"):
    """The main path: the synthetic news20 corpus through TextSet (read ->
    tokenize -> normalize -> word2idx -> shape_sequence -> generate_sample,
    each stage timed), random_split([0.8, 0.2]), then
    ``TextClassifier(embedding_file=..., word_index=...)`` (the frozen
    GloVe path, cnn encoder) fit for 2 epochs, evaluate and predict on the
    holdout, with the accuracy gate against the untrained control; a
    profiled epoch; save through the estimator and reload into a fresh
    model with equal predictions; then the trainable-table variant
    (vocab_size 20,001) and the lstm and gru encoders for 16 steps each."""
    from analytics_zoo_tpu_torch.feature.text import TextSet
    from analytics_zoo_tpu_torch.models import TextClassifier
    from analytics_zoo_tpu_torch.orca.learn.optimizers import Adagrad
    cfg = NEWS20
    stages = {}
    t0 = time.perf_counter()
    news, glove, n_tokens = news20_corpus(root)
    stages["write_corpus_s"] = time.perf_counter() - t0

    def stage(name, fn):
        t = time.perf_counter()
        out = fn()
        stages[name + "_s"] = time.perf_counter() - t
        return out
    ts = stage("read", lambda: TextSet.read(news))
    stage("tokenize", ts.tokenize)
    stage("normalize", ts.normalize)
    stage("word2idx", lambda: ts.word2idx(remove_topN=cfg["remove_top"],
                                          max_words_num=cfg["max_words"]))
    stage("shape_sequence", lambda: ts.shape_sequence(cfg["seq"]))
    stage("generate_sample", ts.generate_sample)
    train, val = stage("random_split", lambda: ts.random_split([0.8, 0.2]))
    (xtr, ytr), (xva, yva) = stage(
        "to_arrays", lambda: (train.to_arrays(), val.to_arrays()))
    word_index = ts.get_word_index()
    if max(word_index.values()) != cfg["max_words"] or int(
            xtr.max()) > cfg["max_words"]:
        fail(f"word2idx gave {len(word_index)} ids, max "
             f"{max(word_index.values())}")

    def model(**kw):
        m = TextClassifier(cfg["classes"], sequence_length=cfg["seq"],
                           encoder_output_dim=cfg["filters"], device=dev,
                           **kw)
        m.compile(loss="sparse_categorical_crossentropy",
                  optimizer=Adagrad(learningrate=cfg["lr"]),
                  metrics=["accuracy"])
        return m
    tc = stage("glove_model", lambda: model(embedding_file=glove,
                                            word_index=word_index))
    table = tc.module.embedding.detach().clone()
    control = tc.evaluate({"x": xva, "y": yva}, batch_size=cfg["batch"],
                          verbose=False)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    stats = tc.fit({"x": xtr, "y": ytr}, epochs=cfg["epochs"],
                   batch_size=cfg["batch"], profile=True, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    steady, step_ms = _steady_rate(stats, cfg["batch"])
    frozen = bool(torch.equal(tc.module.embedding.detach(), table))
    ev = tc.evaluate({"x": xva, "y": yva}, batch_size=cfg["batch"],
                     verbose=False)
    tc.predict(xva[:cfg["batch"]], batch_size=cfg["batch"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    probs = tc.predict(xva, batch_size=1024)
    predict_s = time.perf_counter() - t
    prof = _fit_profile(lambda: tc.fit({"x": xtr, "y": ytr}, epochs=1,
                                       batch_size=cfg["batch"],
                                       verbose=False))
    path = os.path.join(root, "news20_tc.pt")
    tc.estimator.save(path)
    again = model(embedding_matrix=tc.module.embedding.detach().cpu()
                  .numpy())
    again.estimator.load(path)
    reload_diff = float(np.abs(again.predict(xva[:512], batch_size=256)
                               - tc.predict(xva[:512], batch_size=256)).max())
    del again
    variants = {}
    for name, kw in (("trainable_table", dict(vocab_size=cfg["max_words"]
                                              + 1, embed_dim=cfg["embed"])),
                     ("lstm", dict(embedding_matrix=table.cpu().numpy(),
                                   encoder="lstm")),
                     ("gru", dict(embedding_matrix=table.cpu().numpy(),
                                  encoder="gru"))):
        m = model(**kw)
        t = time.perf_counter()
        s = m.fit({"x": xtr, "y": ytr}, epochs=1, batch_size=cfg["batch"],
                  steps_per_epoch=cfg["rnn_steps"], profile=True,
                  verbose=False)
        torch.cuda.synchronize()
        variants[name] = {"steps": cfg["rnn_steps"],
                          "fit_s": time.perf_counter() - t,
                          "loss": s[-1]["train_loss"],
                          "step_ms_median": statistics.median(
                              s[-1]["profile"]["step_ms"][2:] or
                              s[-1]["profile"]["step_ms"])}
        if not math.isfinite(s[-1]["train_loss"]):
            fail(f"news20 {name} variant: loss {s[-1]['train_loss']}")
        del m
    acc, acc0 = float(ev["accuracy"]), float(control["accuracy"])
    ok = (acc > NEWS20_GATE and acc0 <= NEWS20_GATE and frozen
          and reload_diff <= 1e-6 and probs.shape == (len(xva),
                                                     cfg["classes"])
          and bool(np.isfinite(probs).all()))
    samples = len(xtr) * cfg["epochs"]
    emit({"phase": "text_classifier_news20", "config": cfg,
          "docs": len(ts.features), "tokens": n_tokens,
          "train_rows": len(xtr), "holdout_rows": len(xva),
          "word_index": len(word_index), "textset_stages_s": stages,
          "fit_s": fit_s, "fit_samples_per_s": samples / fit_s,
          "steady_samples_per_s": steady, "steady_step_ms": step_ms,
          "epoch_losses": [s["train_loss"] for s in stats],
          "fuse": tc.estimator.fuse, "peak_memory_bytes": peak,
          "peak_above_held_bytes": peak - held,
          "holdout_accuracy": acc, "control_untrained_accuracy": acc0,
          "gate": NEWS20_GATE, "frozen_table_bit_equal": frozen,
          "predict_rows_per_s": len(xva) / predict_s,
          "profiled_epoch": prof, "reload_max_abs_diff": reload_diff,
          "variants": variants, "ok": ok, "card": card})
    if not ok:
        fail(f"news20 TextClassifier: accuracy {acc} (control {acc0}, "
             f"gate {NEWS20_GATE}), frozen {frozen}, reload {reload_diff}")


def _text_cases():
    """name -> (build(dev) -> model, its module, fit(model, steps),
    predict(model), sample input for lazy widths), at TEXT_VS_CPU's
    widths."""
    from analytics_zoo_tpu_torch.models import KNRM, Seq2Seq, TextClassifier
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.tfpark.text import NER, IntentEntity
    c = TEXT_VS_CPU
    rng = np.random.RandomState(c["seed"])
    n = c["batch"] * (c["steps"] + 2)
    ids = rng.randint(1, c["vocab"], (n, c["seq"])).astype(np.int32)
    labels = rng.randint(0, c["classes"], n).astype(np.int32)
    chars = rng.randint(1, 40, (n, c["seq"], 6)).astype(np.int32)
    tags = (ids % 5 + 1).astype(np.int32)
    src, tgt = ids[:, :12], ids[:, 12:22] % 60
    rel = (rng.rand(n, 1) > 0.5).astype(np.float32)
    fit_kw = dict(batch_size=c["batch"], shuffle=False, verbose=False)

    def zoo(model, data):
        def fit(m, steps):
            m.fit(data, epochs=1, steps_per_epoch=steps, **fit_kw)
        return model, (lambda m: m.module), fit

    def tc(encoder):
        def build(dev):
            m = TextClassifier(c["classes"], vocab_size=c["vocab"],
                               embed_dim=c["embed"], sequence_length=c["seq"],
                               encoder=encoder, encoder_output_dim=24,
                               device=dev)
            m.module.dropout.p = 0.0
            return m.compile(loss="sparse_categorical_crossentropy",
                             optimizer="adam")
        return zoo(build, {"x": ids, "y": labels})

    def keras(layers):
        def build(dev):
            return Sequential(layers(), device=dev).compile(
                "adam", "sparse_categorical_crossentropy")

        def fit(m, steps):
            m.fit(ids, labels, nb_epoch=1, steps_per_epoch=steps, **fit_kw)
        return build, (lambda m: m.to_module()), fit

    def emb():
        return L.Embedding(c["vocab"], c["embed"], input_shape=(c["seq"],))

    def knrm(dev):
        m = KNRM(10, 40, vocab_size=c["vocab"], embed_size=c["embed"],
                 target_mode="classification", device=dev)
        return m.compile(loss="binary_crossentropy", optimizer="adam")

    def s2s(kind):
        def build(dev):
            m = Seq2Seq(kind, 1, 32, c["vocab"], 60, c["embed"], device=dev)
            return m.compile(loss="sparse_categorical_crossentropy",
                             optimizer="adam")
        return zoo(build, {"x": (src, tgt), "y": tgt})

    def tagger(cls, **kw):
        def build(dev):
            return cls(vocab_size=c["vocab"], lstm_units=24, dropout=0.0,
                       word_emb_dim=c["embed"], device=dev, **kw)
        return build, (lambda m: m.module)

    def ner_fit(m, steps):
        m.fit((ids, chars), tags, epochs=1, steps_per_epoch=steps, **fit_kw)

    def ie_fit(m, steps):
        m.fit(ids, labels % 3, tags, epochs=1, steps_per_epoch=steps,
              **fit_kw)
    cases = {
        "text_classifier_cnn": tc("cnn") + (lambda m: m.predict(ids[-64:]),
                                            None),
        "text_classifier_lstm": tc("lstm") + (lambda m: m.predict(
            ids[-64:]), None),
        "text_classifier_gru": tc("gru") + (lambda m: m.predict(ids[-64:]),
                                            None),
        "keras_text_cnn": keras(lambda: [
            emb(), L.Convolution1D(32, 5, activation="relu"),
            L.GlobalMaxPooling1D(),
            L.Dense(c["classes"], activation="softmax")])
        + (lambda m: m.predict(ids[-64:]), ids[:1]),
        "keras_lstm_hard_sigmoid": keras(lambda: [
            emb(), L.LSTM(24), L.Dense(c["classes"], activation="softmax")])
        + (lambda m: m.predict(ids[-64:]), ids[:1]),
        "keras_lstm_sigmoid": keras(lambda: [
            emb(), L.LSTM(24, inner_activation="sigmoid"),
            L.Dense(c["classes"], activation="softmax")])
        + (lambda m: m.predict(ids[-64:]), ids[:1]),
        "keras_bidirectional_gru": keras(lambda: [
            emb(), L.Bidirectional(L.GRU(16)),
            L.Dense(c["classes"], activation="softmax")])
        + (lambda m: m.predict(ids[-64:]), ids[:1]),
        "knrm": zoo(knrm, {"x": ids, "y": rel})
        + (lambda m: m.predict(ids[-64:]), None),
        "seq2seq_lstm": s2s("lstm") + (lambda m: m.predict(
            (src[-64:], tgt[-64:])), None),
        "seq2seq_gru": s2s("gru") + (lambda m: m.predict(
            (src[-64:], tgt[-64:])), None),
        "ner": tagger(NER, num_tags=6, char_vocab_size=40, char_emb_dim=8)
        + (ner_fit, lambda m: m.estimator.predict(
            {"x": (ids[-64:], chars[-64:])}, batch_size=32),
           (ids[:1], chars[:1])),
        "intent_entity": tagger(IntentEntity, num_intents=3,
                                num_entities=6)
        + (ie_fit, lambda m: _intent_entity_logits(m.estimator.predict(
            ids[-64:], batch_size=32)), (ids[:1],)),
    }
    return cases


def _intent_entity_logits(packed):
    """IntentEntity's intent and slot logits out of its packed output,
    without the -1e9 padding (3 intents, 6 entities)."""
    return np.concatenate([packed[:, 0, :3].ravel(),
                           packed[:, 1:, :6].ravel()])


def _materialize(module, sample):
    if sample is not None:
        module.eval()
        with torch.no_grad():
            module(*(torch.from_numpy(a) for a in (
                sample if isinstance(sample, tuple) else (sample,))))


def _text_run(case, dev, state, steps):
    """``steps`` steps of a ``_text_cases`` case on ``dev`` from ``state``
    (None: the model's own draw): the start and end parameters and the
    predictions, on the CPU."""
    build, module_of, fit, predict, sample = case
    m = build(dev)
    module = module_of(m)
    if state is None:
        _materialize(module, sample)
    else:
        module.load_state_dict(state)
    start = {k: v.detach().cpu().clone()
             for k, v in module.state_dict().items()}
    fit(m, steps)
    params = {k: v.detach().cpu().clone()
              for k, v in module_of(m).state_dict().items()}
    return start, params, np.asarray(predict(m))


def _param_rels(got, want):
    """Each leaf's largest difference relative to its largest entry."""
    return {k: float((got[k].double() - want[k].double()).abs().max())
            / max(float(want[k].double().abs().max()), 1e-30) for k in want}


def _param_rel(got, want):
    return max(_param_rels(got, want).values())


def text_models_vs_cpu_phase(card, dev="cuda"):
    """Each text model (TextClassifier's three encoders, a Keras text CNN,
    a Keras LSTM on its loop and its cuDNN branch, a Bidirectional GRU,
    KNRM, Seq2seq LSTM and GRU, NER and IntentEntity) trains 3 steps
    through its user's fit on the card and on the CPU from the same
    weights; parameters and predictions held to TOL_TEXT_VS_CPU, the card
    with one more step the control that must miss."""
    c = TEXT_VS_CPU
    result, failed = {}, []
    t0 = time.perf_counter()
    for name, case in _text_cases().items():
        start, cpu_params, cpu_pred = _text_run(case, "cpu", None,
                                                c["steps"])
        sd = {k: v.clone() for k, v in start.items()}
        _, card_params, card_pred = _text_run(case, dev, sd, c["steps"])
        _, ctl_params, ctl_pred = _text_run(case, dev, sd, c["steps"] + 1)

        def readings(params, pred):
            scale = max(float(np.abs(cpu_pred).max()), 1e-30)
            return {"param": _param_rel(params, cpu_params),
                    "pred": float(np.abs(pred - cpu_pred).max()) / scale}
        got, ctl = readings(card_params, card_pred), readings(ctl_params,
                                                              ctl_pred)
        ok = (all(got[k] <= TOL_TEXT_VS_CPU[k] for k in got)
              and all(ctl[k] > TOL_TEXT_VS_CPU[k] for k in ctl)
              and bool(np.isfinite(card_pred).all()))
        rels = _param_rels(card_params, cpu_params)
        result[name] = {"readings": got, "control_readings": ctl,
                        "worst_leaf": max(rels, key=rels.get), "ok": ok}
        if not ok:
            failed.append(name)
    emit({"phase": "text_models_vs_cpu", "widths": c,
          "limits": TOL_TEXT_VS_CPU,
          "control": "the card with one more step", **result,
          "run_s": time.perf_counter() - t0, "card": card})
    if failed:
        fail(f"text models on the card disagree with the CPU: {failed}")


def _wikiqa_pairs(cfg, rng):
    """Seeded question/answer corpora and relations in WikiQA's shape:
    each question has ``answers_per_q`` candidates, one or two relevant,
    and a relevant answer shares words with its question."""
    from analytics_zoo_tpu_torch.feature.text import TextFeature, TextSet
    v = cfg["vocab"]
    qs, ans, rels = [], [], []
    for q in range(cfg["questions"]):
        qw = rng.randint(1, v, cfg["q_len"])
        qs.append(TextFeature(" ".join(f"w{i}" for i in qw), uri=f"q{q}"))
        for a in range(cfg["answers_per_q"]):
            aw = rng.randint(1, v, cfg["a_len"])
            label = int(a < 1 + q % 2)
            if label:
                aw[rng.choice(cfg["a_len"], 8, replace=False)] = \
                    rng.choice(qw, 8)
            ans.append(TextFeature(" ".join(f"w{i}" for i in aw),
                                   uri=f"q{q}a{a}"))
            rels.append((f"q{q}", f"q{q}a{a}", label))
    c1, c2 = TextSet(qs), TextSet(ans)
    index = {f"w{i}": i for i in range(1, v)}
    for ts, n in ((c1, cfg["q_len"]), (c2, cfg["a_len"])):
        ts.tokenize().normalize().word2idx(existing_map=index)
        ts.shape_sequence(n)
    return c1, c2, rels


def text_family_paths_phase(card, dev="cuda"):
    """KNRM at WikiQA's widths over TextSet.from_relation_pairs, with
    evaluate_ndcg (k 3, 5) and evaluate_map; Seq2seq (LSTM, hidden 128) on
    the reversal task with tests/test_models_zoo.py's gates, then infer
    (max_seq_len 30) with tokens equal to the port's CPU tokens from the
    same weights; NER at its defaults and IntentEntity a few steps each;
    a Keras LSTM at width 128 over 50 steps, its hard_sigmoid loop's step
    time beside the sigmoid (cuDNN) branch's."""
    from analytics_zoo_tpu_torch.feature.text import TextSet
    from analytics_zoo_tpu_torch.models import KNRM, Seq2Seq
    from analytics_zoo_tpu_torch.models.common.ranker import (
        mean_average_precision, ndcg)
    from analytics_zoo_tpu_torch.orca.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.tfpark.text import NER, IntentEntity
    out = {}
    rng = np.random.RandomState(5)
    # KNRM
    k = KNRM_WIKIQA
    t0 = time.perf_counter()
    c1, c2, rels = _wikiqa_pairs(k, rng)
    pairs = TextSet.from_relation_pairs(rels, c1, c2)
    x = np.stack([f.indices for f in pairs.features])
    # a pair row holds [q, pos] then [q, neg]: each half is one scored row
    half = k["q_len"] + k["a_len"]
    xs = np.concatenate([x[:, :half], x[:, half:]])
    ys = np.concatenate([np.ones((len(x), 1)), np.zeros((len(x), 1))]
                        ).astype(np.float32)
    knrm = KNRM(k["q_len"], k["a_len"], vocab_size=k["vocab"],
                embed_size=k["embed"], kernel_num=k["kernels"],
                sigma=k["sigma"], exact_sigma=k["exact_sigma"],
                target_mode="classification", device=dev)
    knrm.compile(loss="binary_crossentropy", optimizer=Adam(lr=k["lr"]))
    lists = TextSet.from_relation_lists(rels, c1, c2).features
    lx = np.concatenate([f.indices for f in lists])
    ly = np.concatenate([f.label for f in lists]).astype(np.float32)

    def rank_metrics():
        """Per-question NDCG and MAP, averaged over the questions."""
        by_q = len(lists[0].label)
        scores = knrm.predict(lx, batch_size=1024).reshape(-1, by_q)
        lab = ly.reshape(-1, by_q)
        return {"ndcg@3": float(np.mean([ndcg(a, b, 3)
                                         for a, b in zip(lab, scores)])),
                "ndcg@5": float(np.mean([ndcg(a, b, 5)
                                         for a, b in zip(lab, scores)])),
                "map": float(np.mean([mean_average_precision(a, b)
                                      for a, b in zip(lab, scores)]))}
    before = rank_metrics()
    stats = knrm.fit({"x": xs, "y": ys}, epochs=k["epochs"],
                     batch_size=k["batch"], verbose=False)
    after = rank_metrics()
    flat = {"evaluate_ndcg@3": knrm.evaluate_ndcg(lx, ly, 3),
            "evaluate_ndcg@5": knrm.evaluate_ndcg(lx, ly, 5),
            "evaluate_map": knrm.evaluate_map(lx, ly)}
    out["knrm"] = {"widths": k, "pairs": len(x),
                   "epoch_losses": [s["train_loss"] for s in stats],
                   "per_question_before": before,
                   "per_question_after": after, **flat,
                   "map_gate": KNRM_MAP_GATE,
                   "run_s": time.perf_counter() - t0}
    if not (all(math.isfinite(v) for v in flat.values())
            and after["map"] >= KNRM_MAP_GATE
            and stats[-1]["train_loss"] < stats[0]["train_loss"]):
        fail(f"KNRM on WikiQA's widths did not learn: {out['knrm']}")
    del knrm
    # Seq2seq on the reversal task
    s = S2S_REVERSAL
    t0 = time.perf_counter()
    r = np.random.RandomState(0)
    src = r.randint(2, s["vocab"], (s["rows"], s["seq"])).astype(np.int32)
    reply = src[:, ::-1].copy()
    tgt_in = np.concatenate([np.full((len(src), 1), 1, np.int32),
                             reply[:, :-1]], 1)
    s2s = Seq2Seq("lstm", 1, s["hidden"], s["vocab"], s["vocab"],
                  s["embed"], device=dev)
    s2s.compile(loss="sparse_categorical_crossentropy", optimizer="adam")
    stats = s2s.fit({"x": (src, tgt_in), "y": reply}, epochs=s["epochs"],
                    batch_size=s["batch"], verbose=False)
    preds = s2s.predict((src[:256], tgt_in[:256]))
    acc = float((np.argmax(preds, -1) == reply[:256]).mean())
    ratio = stats[-1]["train_loss"] / stats[0]["train_loss"]
    tokens = s2s.infer(src[:64], start_sign=1, max_seq_len=s["infer_len"])
    cpu = Seq2Seq("lstm", 1, s["hidden"], s["vocab"], s["vocab"],
                  s["embed"], device="cpu")
    cpu.module.load_state_dict({n: t.cpu() for n, t in
                                s2s.module.state_dict().items()})
    cpu_tokens = cpu.infer(src[:64], start_sign=1,
                           max_seq_len=s["infer_len"])
    same = tokens.tolist() == cpu_tokens.tolist()
    out["seq2seq"] = {"widths": s, "loss_ratio": ratio,
                      "teacher_forced_accuracy": acc,
                      "gates": {"loss_ratio": 0.7,
                                "accuracy": 3.0 / (s["vocab"] - 2)},
                      "infer_tokens_equal_cpu": same,
                      "infer_shape": list(tokens.shape),
                      "run_s": time.perf_counter() - t0}
    if not (ratio < 0.7 and acc > 3.0 / (s["vocab"] - 2) and same):
        fail(f"Seq2seq reversal on the card: {out['seq2seq']}")
    del s2s, cpu
    # taggers at their defaults
    g = TAGGERS
    t0 = time.perf_counter()
    words = r.randint(1, g["vocab"], (g["rows"], g["sent"])).astype(np.int32)
    chars = r.randint(1, g["chars"], (g["rows"], g["sent"], g["word_len"])
                      ).astype(np.int32)
    tags = (words % (g["tags"] - 1) + 1).astype(np.int32)
    ner = NER(num_tags=g["tags"], vocab_size=g["vocab"],
              char_vocab_size=g["chars"], device=dev)
    ner_stats = ner.fit((words, chars), tags, batch_size=g["batch"],
                        epochs=1, steps_per_epoch=g["steps"], profile=True,
                        verbose=False)
    ner_pred = ner.estimator.predict({"x": (words[:128], chars[:128])},
                                     batch_size=64)
    ie = IntentEntity(num_intents=g["intents"], num_entities=g["tags"],
                      vocab_size=g["vocab"], device=dev)
    ie_stats = ie.fit(words, words[:, 0] % g["intents"], tags,
                      batch_size=g["batch"], epochs=1,
                      steps_per_epoch=g["steps"], profile=True,
                      verbose=False)
    intent, slots = ie.predict(words[:128], batch_size=64)
    out["taggers"] = {
        "widths": g, "ner_loss": ner_stats[-1]["train_loss"],
        "ner_step_ms": statistics.median(ner_stats[-1]["profile"]["step_ms"]),
        "intent_entity_loss": ie_stats[-1]["train_loss"],
        "intent_entity_step_ms": statistics.median(
            ie_stats[-1]["profile"]["step_ms"]),
        "run_s": time.perf_counter() - t0}
    if not (np.isfinite(ner_pred).all() and ner_pred.shape == (
            128, g["sent"], g["tags"]) and intent.shape == (128,)
            and slots.shape == (128, g["sent"])
            and math.isfinite(ie_stats[-1]["train_loss"])):
        fail(f"the taggers on the card: {out['taggers']}")
    del ner, ie
    # the Keras LSTM's loop branch against its cuDNN branch
    kl = KERAS_LSTM
    xk = torch.randn(kl["batch"], kl["steps"], kl["features"], device=dev)
    times = {}
    for gate in ("hard_sigmoid", "sigmoid"):
        net = Sequential([L.LSTM(kl["width"], inner_activation=gate,
                                 input_shape=(kl["steps"],
                                              kl["features"]))],
                         device=dev)
        module = net.to_module().to(dev)

        def step():
            module.zero_grad(set_to_none=True)
            module(xk).sum().backward()
        for _ in range(3):
            step()
        times[gate] = _span_ms(_eager(step, kl["reps"]), kl["reps"])
    out["keras_lstm_step_ms"] = {"loop_hard_sigmoid": times["hard_sigmoid"],
                                 "cudnn_sigmoid": times["sigmoid"],
                                 "widths": kl,
                                 "timing": "CUDA events over 20 eager "
                                           "forward+backward steps"}
    emit({"phase": "text_family_paths", **out, "card": card})


def _wnd_frame(cfg, rng):
    """MovieLens-1M-shaped rows in Wide & Deep's layout from bench_ncf's
    synthetic (user, item) pairs: users' gender, age and occupation and
    items' genres drawn once; label rating >= 3."""
    pairs, ratings = _ncf_data(cfg["rows"])
    users, items = pairs[:, 0], pairs[:, 1] % cfg["items"]
    gender = rng.randint(0, 3, cfg["users"] + 1)
    age = rng.randint(0, 7, cfg["users"] + 1)
    occ = rng.randint(0, 21, cfg["users"] + 1)
    genres = (rng.rand(cfg["items"] + 1, 19) < 0.12).astype(np.float32)
    n = len(users)
    eye = lambda d, i: np.eye(d, dtype=np.float32)[i]
    g, a = gender[users], age[users]
    cross = (a * 3 + g) % 100
    x = np.concatenate([
        eye(21, occ[users]), eye(3, g), eye(100, cross),      # wide
        genres[items], eye(3, g),                             # indicators
        np.stack([users, items], 1).astype(np.float32),       # embed ids
        (a[:, None] / 6.0).astype(np.float32)], 1)           # continuous
    y = (ratings >= 3).astype(np.int32)
    if x.shape != (n, 124 + 22 + 2 + 1):
        fail(f"Wide & Deep rows have shape {x.shape}")
    return x, y


def recsys_anomaly_paths_phase(card, dev="cuda"):
    """Wide & Deep at MovieLens-1M's widths (1 epoch at batch 1,024, then
    recommend_for_user), SessionRecommender (item_count 3,952, sessions of
    5, history 10) and AnomalyDetector over the NYC-taxi series (unroll
    24, hidden (8, 32, 15), dropout 0.2, fit then detect_anomalies), with
    the detector's card-vs-CPU steps (dropout off)."""
    from analytics_zoo_tpu_torch.models import (AnomalyDetector,
                                                ColumnFeatureInfo,
                                                SessionRecommender,
                                                WideAndDeep)
    out = {}
    rng = np.random.RandomState(0)
    w = WND
    t0 = time.perf_counter()
    x, y = _wnd_frame(w, rng)
    info = ColumnFeatureInfo(
        wide_base_cols=["occupation", "gender"], wide_base_dims=[21, 3],
        wide_cross_cols=["age-gender"], wide_cross_dims=[100],
        indicator_cols=["genres", "gender"], indicator_dims=[19, 3],
        embed_cols=["userId", "itemId"], embed_in_dims=[w["users"],
                                                        w["items"]],
        embed_out_dims=[64, 64], continuous_cols=["age"])
    wnd = WideAndDeep(2, info, hidden_layers=(40, 20, 10), device=dev)
    wnd.compile(loss="sparse_categorical_crossentropy", optimizer="adam",
                metrics=["accuracy"])
    t = time.perf_counter()
    stats = wnd.fit({"x": x, "y": y}, epochs=w["epochs"],
                    batch_size=w["batch"], profile=True, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    steady, step_ms = _steady_rate(stats, w["batch"])
    recs = wnd.recommend_for_user(x[:2000], max_items=5)
    out["wide_and_deep"] = {
        "rows": len(x), "feature_width": info.feature_width(),
        "fit_s": fit_s, "fit_samples_per_s": len(x) * w["epochs"] / fit_s,
        "steady_samples_per_s": steady, "steady_step_ms": step_ms,
        "fuse": wnd.estimator.fuse, "loss": stats[-1]["train_loss"],
        "users_recommended": len(recs), "run_s": time.perf_counter() - t0}
    if not (math.isfinite(stats[-1]["train_loss"]) and recs and all(
            0 < len(v) <= 5 for v in recs.values())):
        fail(f"Wide & Deep on the card: {out['wide_and_deep']}")
    del wnd, x, y
    # SessionRecommender with history
    s = SESSION
    t0 = time.perf_counter()
    seq = rng.randint(1, s["items"] + 1, (s["rows"], s["session"] + 1))
    hist = rng.randint(1, s["items"] + 1, (s["rows"], s["history"]))
    sx = np.concatenate([seq[:, :-1], hist], 1).astype(np.int32)
    sy = seq[:, -1].astype(np.int32)
    sr = SessionRecommender(s["items"], item_embed=100,
                            rnn_hidden_layers=(40, 20),
                            session_length=s["session"],
                            include_history=True,
                            mlp_hidden_layers=(40, 20),
                            history_length=s["history"], device=dev)
    sr.compile(loss="sparse_categorical_crossentropy", optimizer="adam")
    stats = sr.fit({"x": sx, "y": sy}, epochs=s["epochs"],
                   batch_size=s["batch"], profile=True, verbose=False)
    recs = sr.recommend_for_session(sx[:64], max_items=5)
    out["session_recommender"] = {
        "steps": len(stats[-1]["profile"]["step_ms"]),
        "loss": stats[-1]["train_loss"],
        "steady_step_ms": _steady_rate(stats, s["batch"])[1],
        "fuse": sr.estimator.fuse, "run_s": time.perf_counter() - t0}
    if not (math.isfinite(stats[-1]["train_loss"]) and len(recs) == 64
            and all(len(r) == 5 for r in recs)):
        fail(f"SessionRecommender on the card: {out['session_recommender']}")
    del sr
    # AnomalyDetector over the NYC-taxi series
    a = ANOMALY
    t0 = time.perf_counter()
    values = np.loadtxt(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests", "resources",
        "nyc_taxi_subset.csv"), delimiter=",", skiprows=1, usecols=1,
        dtype=np.float32)
    series = ((values - values.mean()) / values.std()).reshape(-1, 1)
    ax, ay = AnomalyDetector.unroll(series, a["unroll"])
    drops = (a["dropout"],) * len(a["hidden"])
    ad = AnomalyDetector((a["unroll"], 1), a["hidden"], drops, device=dev)
    ad.compile(loss="mean_squared_error", optimizer="adam")
    stats = ad.fit({"x": ax, "y": ay}, epochs=a["epochs"],
                   batch_size=a["batch"], verbose=False)
    pred = ad.predict(ax, batch_size=1024)
    anomalies = AnomalyDetector.detect_anomalies(ay, pred, a["anomalies"])

    def steps(dev, state, n):
        m = AnomalyDetector((a["unroll"], 1), a["hidden"],
                            (0.0,) * len(a["hidden"]), device=dev)
        if state is not None:
            m.module.load_state_dict(state)
        m.compile(loss="mean_squared_error", optimizer="adam")
        start = {k: v.detach().cpu().clone()
                 for k, v in m.module.state_dict().items()}
        m.fit({"x": ax, "y": ay}, epochs=1, batch_size=a["batch"],
              steps_per_epoch=n, shuffle=False, verbose=False)
        return start, {k: v.detach().cpu().clone() for k, v in
                       m.module.state_dict().items()}, m.predict(ax[:512])
    start, cpu_params, cpu_pred = steps("cpu", None, 3)
    _, card_params, card_pred = steps(dev, start, 3)
    _, ctl_params, ctl_pred = steps(dev, start, 4)
    scale = max(float(np.abs(cpu_pred).max()), 1e-30)
    got = {"param": _param_rel(card_params, cpu_params),
           "pred": float(np.abs(card_pred - cpu_pred).max()) / scale}
    ctl = {"param": _param_rel(ctl_params, cpu_params),
           "pred": float(np.abs(ctl_pred - cpu_pred).max()) / scale}
    out["anomaly_detector"] = {
        "windows": len(ax), "epoch_losses": [s_["train_loss"]
                                             for s_ in stats],
        "anomalies": len(anomalies), "top_anomaly": anomalies[0] if
        anomalies else None, "vs_cpu": got, "vs_cpu_control": ctl,
        "limits": TOL_ANOMALY_VS_CPU, "run_s": time.perf_counter() - t0}
    if not (len(anomalies) >= a["anomalies"] and all(
            got[k] <= TOL_ANOMALY_VS_CPU[k] for k in got) and all(
            ctl[k] > TOL_ANOMALY_VS_CPU[k] for k in ctl)):
        fail(f"AnomalyDetector on the card: {out['anomaly_detector']}")
    emit({"phase": "recsys_anomaly_paths", **out, "card": card})


def text_zoo_paths(card):
    """The text, ranking, sequence and recommendation models' four phases,
    each path driven with the flash kernels' counts at 0 (none of them
    reaches one). Returns the counts by path."""
    from analytics_zoo_tpu_torch.ops import attention as at
    kernels = [getattr(at, name) for name in FLASH_KERNELS]
    launches = {}
    root = tempfile.mkdtemp(prefix="news20-")
    try:
        for name, run in (
                ("text_classifier_news20",
                 lambda: text_classifier_news20_phase(card, root)),
                ("text_models_vs_cpu", lambda: text_models_vs_cpu_phase(
                    card)),
                ("text_family_paths", lambda: text_family_paths_phase(card)),
                ("recsys_anomaly_paths",
                 lambda: recsys_anomaly_paths_phase(card))):
            for fn in kernels:
                fn.launches = 0
            run()
            launches[name] = {fn.__name__: fn.launches for fn in kernels}
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if any(n for counts in launches.values() for n in counts.values()):
        fail(f"a flash kernel launched on a text or recommendation path: "
             f"{launches}")
    return launches

# --- image inputs and image classification (slice 16) ----------------------
IMAGE_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "data", "images")
# nvJPEG's decode of each fixture JPEG against cv2.imread's (stored as
# PNG), per file over every pixel: the largest difference, the mean and
# the share of pixels more than 2 levels off. libjpeg-turbo's "fancy"
# chroma upsampling differs from nvJPEG's at hard colour edges (4:4:4 and
# greyscale files: max 3 and 1). Readings, the first card run (H100 80GB
# HBM3, 700 W): mean <= 1.334, share <= 0.0848 (j420_odd.jpg), max <= 93
# (j420.jpg). Controls, each file's picture encoded at quality 30 and
# decoded by cv2: mean >= 1.741, share >= 0.153 (grey.jpg), max 20-115.
# Each control must miss the mean and the share limits; the max limit is
# a bound on a garbled decode only, which a control does not miss.
TOL_NVJPEG = {"max": 120, "mean": 1.5, "share_gt2": 0.12}
NVJPEG_RATE_ROUNDS = 4


def _diff_stats(got, want):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return {"max": int(d.max()), "mean": float(d.mean()),
            "share_gt2": float((d > 2).mean())}


def _within(stats, tol):
    return all(stats[k] <= tol[k] for k in tol)


def image_codecs_phase(card):
    """nvJPEG's decode of every fixture JPEG (``csrc/jpeg_decode.cu``) held
    against cv2's (stored as PNG), with each file's quality-30 control,
    which must miss the limits; every PNG and BMP fixture decoded bit for
    bit equal to cv2's stored array; the decode rate of the JPEGs on the
    card. Returns nvJPEG's launches in this phase."""
    from analytics_zoo_tpu_torch.feature.image import codecs
    from analytics_zoo_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    _kernels.load("jpeg_decode")
    build_s = time.perf_counter() - t0
    with open(os.path.join(IMAGE_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)

    def read(rel):
        with open(os.path.join(IMAGE_FIXTURES, rel), "rb") as f:
            return f.read()

    codecs.nvjpeg_decode.launches = 0
    jpegs, exact = {}, {}
    for rel, entry in sorted(manifest.items()):
        want = codecs.decode_png(read(entry["expected"]))
        if rel.endswith(".jpg"):
            got = codecs.decode_image(read(rel), "cuda")
            control = codecs.decode_png(read(entry["control_q30"]))
            if got.shape != want.shape:
                fail(f"image_codecs: {rel} decodes to {got.shape}, cv2 to "
                     f"{want.shape}")
            jpegs[rel] = {"shape": list(got.shape),
                          "covers": entry["covers"],
                          "nvjpeg": _diff_stats(got, want),
                          "control_q30": _diff_stats(control, want)}
        else:
            got = codecs.decode_image(read(rel), "cuda")
            exact[rel] = bool(got.shape == want.shape
                              and np.array_equal(got, want))
    launches = codecs.nvjpeg_decode.launches
    # decode rate: every fixture JPEG, NVJPEG_RATE_ROUNDS times, on the card
    # (host Huffman decode + device IDCT/colour), synchronised at the end
    datas = [read(rel) for rel in sorted(jpegs)]
    pixels = sum(int(np.prod(jpegs[rel]["shape"])) for rel in sorted(jpegs))
    codecs.nvjpeg_decode(datas[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NVJPEG_RATE_ROUNDS):
        for data in datas:
            codecs.nvjpeg_decode(data)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = NVJPEG_RATE_ROUNDS * len(datas)
    rate = {"images_per_s": n / dt,
            "compressed_mb_per_s": NVJPEG_RATE_ROUNDS * sum(map(len, datas))
            / dt / 1e6,
            "decoded_mb_per_s": NVJPEG_RATE_ROUNDS * pixels / dt / 1e6,
            "images": n, "seconds": dt,
            "method": "host clock around nvjpeg_decode calls of one "
                      "thread, cuda synchronised at the end"}
    emit({"phase": "image_codecs", "nvidia_smi": card,
          "build_s": build_s, "nvjpeg_link": _kernels.link_flags(
              "jpeg_decode"), "jpeg": jpegs, "tol_nvjpeg": TOL_NVJPEG,
          "png_bmp_exact": exact, "launches": launches, "rate": rate})
    for rel, r in jpegs.items():
        if not _within(r["nvjpeg"], TOL_NVJPEG):
            fail(f"image_codecs: nvJPEG's {rel} misses {TOL_NVJPEG}: "
                 f"{r['nvjpeg']}")
        control = r["control_q30"]
        if (control["mean"] <= TOL_NVJPEG["mean"]
                or control["share_gt2"] <= TOL_NVJPEG["share_gt2"]):
            fail(f"image_codecs: {rel}'s quality-30 control meets a limit "
                 f"of {TOL_NVJPEG}: {control}")
    if not all(exact.values()):
        fail(f"image_codecs: PNG/BMP not bit for bit: "
             f"{[k for k, v in exact.items() if not v]}")
    if launches != len(jpegs):
        fail(f"image_codecs: {launches} nvJPEG launches for {len(jpegs)} "
             f"JPEGs")
    return launches



# the main path: 256 fixture JPEGs (32 copies of each of the 8, in their
# class folders) read and decoded on the card, the ImageNet val
# transforms, Inception-V1 at ImageNet width (1000 classes, bf16) scoring
# them at batch 256 with top-5 labels; MobileNet-V2 trains 8 steps of 64
# on the same ImageSet
IMAGE_PATH = dict(copies=32, crop=224, batch=256, top_k=5, classes=1000,
                  fit_batch=64, fit_epochs=2, seed=16)
# card against CPU, the 8 image modules at 64 px, f32, TF32 off on both:
# the evaluation logits relative to the CPU's largest, the train-mode loss
# relative, one SGD step's parameter update (all leaves) relative to the
# CPU's largest. Readings (the first card run, H100 80GB HBM3, 700 W):
# logits <= 5.9e-6, loss <= 2.4e-6, update <= 1.66e-2 (DenseNet-121;
# BatchNorm over 8 images makes train-step rounding grow; AlexNet and
# SqueezeNet, without BatchNorm, 1.2e-6). Controls, the card on the batch
# rolled by one image: each must miss its limit (the CPU on the rolled
# batch read >= 0.039 on the update, SqueezeNet).
IMAGE_FAMILIES = dict(size=64, batch=8, classes=10, lr=0.1, seed=7)
TOL_IMAGE_VS_CPU = {"logits": 2e-5, "loss": 2e-5, "update": 3e-2}
# SSD-MobileNetV2 at 300 px (21 classes): predict over 64 of the main
# path's JPEGs from an ImageSet; 2 Adam steps of 8 images card against
# CPU; eval loc/conf card against CPU within PR 10's TOL_OD_F32 (the bf16
# trunk the control), detections held with _od_hold at the served limits
# (TOL_OD_SERVED_SCORE/BOX) over decodes at a 0.02 score threshold, where
# the seeded net's near-uniform scores leave rows to hold. Step losses,
# relative to the CPU's, a limit a step: readings (the first card run,
# H100 80GB HBM3, 700 W) 2.9e-6 and 1.6e-3 (Adam's first update on
# train-mode BatchNorm over 8 images grows the rounding); controls, the
# card's steps on the batch rolled by one image, 4.7e-3 and 8.0e-3.
SSD_MB = dict(size=300, classes=20, predict=64, batch=8, steps=2, seed=5,
              hold_threshold=0.02)
TOL_SSD_MB_STEP_LOSS = (1e-4, 4e-3)


def _jpeg_tree(root, copies):
    """``copies`` copies of each fixture JPEG in its class folder under
    ``root``; returns the number of files."""
    n = 0
    with open(os.path.join(IMAGE_FIXTURES, "manifest.json")) as f:
        jpegs = sorted(k for k in json.load(f) if k.endswith(".jpg"))
    for rel in jpegs:
        cls = os.path.basename(os.path.dirname(rel))
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for i in range(copies):
            shutil.copyfile(os.path.join(IMAGE_FIXTURES, rel), os.path.join(
                root, cls, f"{i:03d}_{os.path.basename(rel)}"))
            n += 1
    return n


def _profiled(fn):
    """(result, wall ms, device busy ms, device events) of one call under
    torch.profiler, synchronised."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    return out, wall_ms, _busy_ms(events), len(events)


def image_classifier_inception_v1_phase(card, root, dev="cuda"):
    """The slice's main path through the user's entry points:
    ``ImageSet.read(root, with_label=True)`` decodes IMAGE_PATH's JPEGs on
    the card (nvJPEG), ``.transform(imagenet_val_transforms(224))`` on the
    host, then ``ImageClassifier("inception-v1", num_classes=1000)`` (bf16,
    seeded random weights) ``.predict_image_set(np.stack(...),
    top_k=5)`` at batch 256: a warm call, then one under the profiler (the
    device's busy time and idle share). Host stages in seconds beside the
    device's images/s. Returns the transformed ImageSet."""
    from analytics_zoo_tpu_torch.feature.image import (
        ImageSet, codecs, imagenet_val_transforms)
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    c = IMAGE_PATH
    n = _jpeg_tree(root, c["copies"])
    codecs.nvjpeg_decode.launches = 0
    t0 = time.perf_counter()
    iset = ImageSet.read(root, with_label=True, device=dev)
    images = iset.get_image()
    read_s = time.perf_counter() - t0
    decodes = codecs.nvjpeg_decode.launches
    t0 = time.perf_counter()
    val = iset.transform(imagenet_val_transforms(c["crop"]))
    x = np.stack(val.get_image())
    transform_s = time.perf_counter() - t0
    labels = val.get_label()
    torch.manual_seed(c["seed"])
    clf = ImageClassifier("inception-v1", num_classes=c["classes"],
                          device=dev)
    t0 = time.perf_counter()
    clf.predict_image_set(x, top_k=c["top_k"], batch_size=c["batch"])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    top, wall_ms, busy_ms, n_events = _profiled(
        lambda: clf.predict_image_set(x, top_k=c["top_k"],
                                      batch_size=c["batch"]))
    probs = clf.predict_image_set(x[:8])
    ok_rows = all(len(row) == c["top_k"] and all(
        0 <= int(lab) < c["classes"] for lab, _ in row) and all(
        a[1] >= b[1] for a, b in zip(row, row[1:])) for row in top)
    emit({"phase": "image_classifier_inception_v1", "nvidia_smi": card,
          "images": n, "shapes": sorted({tuple(a.shape) for a in images}),
          "labels": sorted(set(int(v) for v in labels)),
          "nvjpeg_launches": decodes,
          "host_s": {"read_decode": read_s, "transforms": transform_s},
          "host_images_per_s": {"read_decode": n / read_s,
                                "transforms": n / transform_s},
          "predict_first_s": first_s, "predict_wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "device_events": n_events,
          "device_images_per_s": n / (busy_ms / 1e3) if busy_ms else None,
          "wall_images_per_s": n / (wall_ms / 1e3),
          "device_idle_share": 1.0 - busy_ms / wall_ms,
          "top5_first": [[str(lab), float(p)] for lab, p in top[0]],
          "compute_dtype": str(clf.module.compute_dtype)})
    if decodes != n:
        fail(f"image_classifier_inception_v1: {decodes} nvJPEG decodes for "
             f"{n} JPEGs")
    if x.shape != (n, c["crop"], c["crop"], 3) or x.dtype != np.float32:
        fail(f"image_classifier_inception_v1: transformed batch {x.shape} "
             f"{x.dtype}")
    if sorted(set(int(v) for v in labels)) != [1, 2]:
        fail(f"image_classifier_inception_v1: labels {set(labels)}")
    if len(top) != n or not ok_rows:
        fail("image_classifier_inception_v1: malformed top-5 rows")
    if not (np.isfinite(probs).all() and np.allclose(probs.sum(-1), 1.0,
                                                     atol=1e-3)):
        fail("image_classifier_inception_v1: probabilities not finite or "
             "not summing to 1")
    if not busy_ms:
        fail("image_classifier_inception_v1: the profiler saw no device "
             "time")
    return val


def mobilenet_v2_fit_phase(card, val, dev="cuda"):
    """``ImageClassifier("mobilenet-v2", num_classes=1000)`` (bf16) trains
    ``fit_epochs`` epochs of batch 64 over the main path's
    ``ImageSet.to_dataset()`` (8 steps) through ``fit(..., profile=True)``
    with the default ``steps_per_dispatch="auto"`` (a probe, then 4-step
    graph replays): losses finite, the steady samples/s from the per-step
    CUDA-event times."""
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    c = IMAGE_PATH
    torch.manual_seed(c["seed"])
    clf = ImageClassifier("mobilenet-v2", num_classes=c["classes"],
                          device=dev)
    clf.compile()
    t0 = time.perf_counter()
    stats = clf.fit(val.to_dataset(), epochs=c["fit_epochs"],
                    batch_size=c["fit_batch"], profile=True)
    fit_s = time.perf_counter() - t0
    steps = sum(len(s["profile"]["step_ms"]) for s in stats)
    rate, step_ms = _steady_rate(stats, c["fit_batch"])
    losses = [s["train_loss"] for s in stats]
    emit({"phase": "mobilenet_v2_fit", "nvidia_smi": card,
          "steps": steps, "batch": c["fit_batch"], "losses": losses,
          "fit_s": fit_s, "steady_samples_per_s": rate,
          "steady_step_ms": step_ms,
          "step_ms": [ms for s in stats for ms in s["profile"]["step_ms"]],
          "engine_step": clf.estimator.engine.step,
          "compute_dtype": str(clf.module.compute_dtype)})
    if not all(np.isfinite(losses)):
        fail(f"mobilenet_v2_fit: losses {losses}")
    if clf.estimator.engine.step != 8:
        fail(f"mobilenet_v2_fit: {clf.estimator.engine.step} steps, not 8")


def _image_families():
    """name -> constructor of the 8 image modules, f32."""
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        families as fam
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        inception
    return {"alexnet": fam.AlexNet, "vgg16": fam.VGG16, "vgg19": fam.VGG19,
            "mobilenet": fam.MobileNetV1, "mobilenet_v2": fam.MobileNetV2,
            "squeezenet": fam.SqueezeNet, "densenet121": fam.DenseNet121,
            "inception_v1": inception.InceptionV1}


def _sgd_update(module, x, y, lr):
    """(train-mode loss, {name: update}) of one SGD step on ``module``."""
    from analytics_zoo_tpu_torch.orca.learn import losses
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    opt = torch.optim.SGD(module.parameters(), lr=lr)
    module.train()
    opt.zero_grad(set_to_none=True)
    loss = losses.sparse_categorical_crossentropy(
        y, module(x), from_logits=True).mean()
    loss.backward()
    opt.step()
    return float(loss.detach()), {
        n: (p.detach() - before[n]).double().cpu()
        for n, p in module.named_parameters()}


def _sgd_update_rel(got, want):
    top = max(float(w.abs().max()) for w in want.values())
    return max(float((got[n] - want[n]).abs().max()) for n in want) / top


def image_families_vs_cpu_phase(card, dev="cuda"):
    """Each of the 8 image modules from the same seeded weights (dropout
    off) on the card and on the CPU at IMAGE_FAMILIES' size, f32 with TF32
    off on both: the evaluation logits, then one SGD step: its train-mode
    loss and its parameter update, each held as TOL_IMAGE_VS_CPU says,
    with its control (the card on the batch rolled by one image against
    the CPU on the batch), which must miss the limit."""
    import copy
    c = IMAGE_FAMILIES
    rng = np.random.RandomState(c["seed"])
    x = torch.from_numpy(rng.normal(0, 1, (c["batch"], c["size"], c["size"],
                                           3)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, c["classes"], c["batch"]))
    xr = x.roll(1, 0)
    out = {}
    for name, ctor in _image_families().items():
        torch.manual_seed(c["seed"])
        cpu = ctor(num_classes=c["classes"], compute_dtype=torch.float32)
        with torch.no_grad():
            cpu.eval()(x[:1])                 # lazy widths
        for m in cpu.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        card_m = copy.deepcopy(cpu).to(dev)
        control = copy.deepcopy(cpu).to(dev)
        with torch.no_grad():
            want = cpu.eval()(x)
            got = card_m.eval()(x.to(dev)).cpu()
            got_r = card_m(xr.to(dev)).cpu()
        loss_cpu, upd_cpu = _sgd_update(cpu, x, y, c["lr"])
        loss_card, upd_card = _sgd_update(card_m, x.to(dev), y.to(dev),
                                          c["lr"])
        loss_r, upd_r = _sgd_update(control, xr.to(dev), y.to(dev), c["lr"])

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())
        out[name] = {
            "logits": rel(got, want), "loss": abs(loss_card / loss_cpu - 1),
            "update": _sgd_update_rel(upd_card, upd_cpu),
            "control_rolled_batch": {
                "logits": rel(got_r, want),
                "loss": abs(loss_r / loss_cpu - 1),
                "update": _sgd_update_rel(upd_r, upd_cpu)}}
        del cpu, control, card_m
    emit({"phase": "image_families_vs_cpu", "nvidia_smi": card,
          "size": c["size"], "batch": c["batch"], "tol": TOL_IMAGE_VS_CPU,
          "readings": out})
    for name, r in out.items():
        for key, tol in TOL_IMAGE_VS_CPU.items():
            if not r[key] <= tol:
                fail(f"image_families_vs_cpu: {name} {key} {r[key]} > {tol}")
            if r["control_rolled_batch"][key] <= tol:
                fail(f"image_families_vs_cpu: {name}'s {key} control "
                     f"meets its limit: {r}")
    return out


def ssd_mobilenet_v2_paths_phase(card, root, dev="cuda"):
    """``ObjectDetector(model_type="ssd_mobilenet_v2")`` at 300 px:
    ``predict_image_set`` of an ImageSet (SSD_MB["predict"] of the main
    path's JPEGs, resized to 300 and made f32); eval loc/conf of the same
    seeded weights on the card against the CPU (TOL_OD_F32, the card's
    bf16 trunk the control) and their detections (``_od_hold`` at
    TOL_OD_SERVED_SCORE/BOX); 2 Adam steps of 8 images through ``fit``,
    card against CPU, each step's loss within TOL_SSD_MB_STEP_LOSS (the
    card's steps on the batch rolled by one image the control)."""
    import copy

    from analytics_zoo_tpu_torch.feature.image import (
        ImageMatToTensor, ImageResize, ImageSet)
    from analytics_zoo_tpu_torch.models.image.objectdetection import \
        decode_detections
    c = SSD_MB
    names = tuple(f"c{i}" for i in range(c["classes"]))
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                   for f in fs)[:c["predict"]]
    sub = os.path.join(root, "..", "ssd-subset")
    os.makedirs(sub, exist_ok=True)
    for f in files:
        shutil.copyfile(f, os.path.join(sub, os.path.basename(f)))
    t0 = time.perf_counter()
    iset = ImageSet.read(sub, device=dev).transform(
        ImageResize(c["size"], c["size"]) | ImageMatToTensor())
    det = _od_detector(c["size"], names, "ssd_mobilenet_v2",
                       seed=c["seed"], device=dev)
    dets = det.predict_image_set(iset)
    predict_s = time.perf_counter() - t0
    imgs = np.stack(iset.get_image())[:c["batch"]] / 255.0
    imgs = imgs.astype(np.float32)
    # eval loc/conf: the detector's module on the card against a CPU copy
    cpu_net = copy.deepcopy(det.module).cpu().eval()
    card_net = det.module.eval()
    with torch.inference_mode():
        xl = torch.from_numpy(imgs)
        cl, cc = cpu_net(xl)
        gl, gc = card_net(xl.to(dev))
        bl, bc = card_net(xl.to(dev).to(torch.bfloat16))
        post_cpu = decode_detections(
            cl, cc, det.priors,
            score_threshold=c["hold_threshold"]).numpy()
        post_card = decode_detections(
            gl, gc, det.priors,
            score_threshold=c["hold_threshold"]).cpu().numpy()
    held = _od_hold(post_card, post_cpu, TOL_OD_SERVED_SCORE,
                    TOL_OD_SERVED_BOX, threshold=c["hold_threshold"])
    # 2 Adam steps through fit, card against CPU from the same weights
    rng = np.random.RandomState(c["seed"])
    boxes = [np.sort(rng.rand(2, 4).astype(np.float32).reshape(2, 2, 2),
                     axis=1).transpose(0, 2, 1).reshape(2, 4)
             for _ in range(c["batch"])]
    labels = [rng.randint(1, c["classes"] + 1, 2) for _ in range(c["batch"])]
    y = det.pack_targets(boxes, labels, det.max_gt)
    state = {k: v.detach().cpu().clone()
             for k, v in det.module.state_dict().items()}

    def steps(device, x):
        m = _od_detector(c["size"], names, "ssd_mobilenet_v2",
                         seed=c["seed"], device=device)
        m.module.load_state_dict(state)
        m.compile(config={"steps_per_dispatch": 1})
        seen = []
        inner = m.estimator.engine.train_batch

        def train_batch(b):
            loss = inner(b)
            seen.append(float(loss))
            return loss

        m.estimator.engine.train_batch = train_batch
        m.fit({"x": x, "y": y}, epochs=c["steps"], batch_size=c["batch"],
              shuffle=False)
        return seen

    card_losses = steps(dev, imgs)
    cpu_losses = steps("cpu", imgs)
    ctrl_losses = steps(dev, np.roll(imgs, 1, 0))
    rel = [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)]
    ctrl = [abs(a - b) / abs(b) for a, b in zip(ctrl_losses, cpu_losses)]
    readings = {"f32_loc": _od_rel(gl, cl), "f32_conf": _od_rel(gc, cc),
                "control_bf16_loc": _od_rel(bl, cl),
                "control_bf16_conf": _od_rel(bc, cc), "detections": held,
                "step_loss_rel": rel, "step_loss_control_rolled": ctrl}
    emit({"phase": "ssd_mobilenet_v2_paths", "nvidia_smi": card,
          "image_size": c["size"], "predicted": len(dets),
          "predict_s": predict_s, "priors": int(len(det.priors)),
          "detections_per_image": float((dets[..., 0] >= 1).sum(-1).mean()),
          "card_losses": card_losses, "cpu_losses": cpu_losses,
          "readings": readings, "tol": {
              "f32": TOL_OD_F32, "step_loss": TOL_SSD_MB_STEP_LOSS,
              "score": TOL_OD_SERVED_SCORE, "box": TOL_OD_SERVED_BOX}})
    if dets.shape != (c["predict"], 100, 6) or not np.isfinite(dets).all():
        fail(f"ssd_mobilenet_v2_paths: detections {dets.shape}")
    if max(readings["f32_loc"], readings["f32_conf"]) > TOL_OD_F32:
        fail(f"ssd_mobilenet_v2_paths: f32 loc/conf off the CPU's: "
             f"{readings}")
    if max(readings["control_bf16_loc"],
           readings["control_bf16_conf"]) <= TOL_OD_F32:
        fail("ssd_mobilenet_v2_paths: the bf16 control meets TOL_OD_F32")
    if held["worst"] > 1.0 or not held["rows_held"]:
        fail(f"ssd_mobilenet_v2_paths: detections off the CPU's: {held}")
    if len(card_losses) != c["steps"] or any(
            r > tol for r, tol in zip(rel, TOL_SSD_MB_STEP_LOSS)):
        fail(f"ssd_mobilenet_v2_paths: step losses {card_losses} vs "
             f"{cpu_losses}")
    if any(r <= tol for r, tol in zip(ctrl, TOL_SSD_MB_STEP_LOSS)):
        fail(f"ssd_mobilenet_v2_paths: the rolled-batch control meets a "
             f"step-loss limit: {ctrl}")


def image_paths(card):
    """The image slice's five phases, each driven with the flash kernels'
    counts at 0 (none reaches one). Returns the counts by path."""
    from analytics_zoo_tpu_torch.ops import attention as at
    kernels = [getattr(at, name) for name in FLASH_KERNELS]
    launches = {}
    root = tempfile.mkdtemp(prefix="images-")
    jpegs = os.path.join(root, "jpegs")
    state = {}
    try:
        for name, run in (
                ("image_codecs", lambda: image_codecs_phase(card)),
                ("image_classifier_inception_v1", lambda: state.update(
                    val=image_classifier_inception_v1_phase(card, jpegs))),
                ("mobilenet_v2_fit",
                 lambda: mobilenet_v2_fit_phase(card, state["val"])),
                ("image_families_vs_cpu",
                 lambda: image_families_vs_cpu_phase(card)),
                ("ssd_mobilenet_v2_paths",
                 lambda: ssd_mobilenet_v2_paths_phase(card, jpegs))):
            for fn in kernels:
                fn.launches = 0
            run()
            launches[name] = {fn.__name__: fn.launches for fn in kernels}
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if any(n for counts in launches.values() for n in counts.values()):
        fail(f"a flash kernel launched on an image path: {launches}")
    return launches


# --- the TF-migration training surface -------------------------------------
# tfpark_transformer_fit, the main path: TransformerLayer at the JAX
# defaults (GPT-1: vocab 40,990, sequence 77, 12 blocks, 12 heads, hidden
# 768, causal, flash) under a keras2 head (GlobalAveragePooling1D, Dropout
# 0.1, Dense 20 softmax), through tfpark.KerasModel with
# ZooOptimizer(Adam(1e-4), 4), over TFDataset.from_text_set of the news20
# corpus cut to 2,048 documents and 77 ids, batch 32: 16 micro-steps (4
# updates), then evaluate and predict on 512 documents.
TFPARK = dict(vocab=40990, seq_len=77, n_block=12, n_head=12, hidden=768,
              classes=20, docs=2048, batch=32, steps=16, accum=4, lr=1e-4,
              drop=0.1, eval_docs=512, profile_steps=8, seed=0)
# Card vs CPU: the main path's widths cut to 2 blocks, every dropout 0,
# batch 4, 2 accumulation windows (8 micro-steps) from the same weights,
# over the main path's first 36 documents. Limits relative to the largest
# magnitude: the 8 micro-steps' losses and the probe batch's probabilities
# at 5e-5 (readings 9.1e-8 and 1.6e-9 on an H100 80GB HBM3 at 700 W, f32
# with TF32 off: the flash kernels' 3xTF32 and cuBLAS's f32 sums in
# another order than the CPU's; 6.3e-6 and 8.0e-6 on a 64-document corpus
# of its own before); the control, the card with one window fewer (one
# Adam update), reads 0.011 on the probabilities (0.85 before) and must
# miss.
TFPARK_VS_CPU = dict(n_block=2, batch=4, steps=8)
TOL_TFPARK_VS_CPU = {"loss": 5e-5, "probs": 5e-5}
# gan_fit: examples/gan/mnist_gan.py at its defaults (16 px digits, noise
# 32, Adam, batch 128, 4,096 rows) but 20 epochs of its 30: the 30 took
# 13.8-25.6 s of eager host-bound steps on H100 hosts, over the phase
# group's share of the smoke's time; the example's gate passed at 30.
GAN = dict(rows=4096, size=16, noise=32, batch=128, epochs=20, seed=0)
# Card vs CPU: 2 D+G alternations on two batches with the same injected
# noise. Limits: each parameter leaf's largest difference relative to its
# largest entry at 1e-4 (reading 3.2e-5 on an H100 80GB HBM3 at 700 W:
# Adam's first updates normalise gradient entries near zero, whose last
# bits differ between cuDNN's convs and the CPU's), the losses at 1e-5
# (reading 5.1e-7); the control, one alternation fewer on the card, reads
# 0.50 on the parameters and must miss.
GAN_VS_CPU = dict(alternations=2)
TOL_GAN_VS_CPU = {"param": 1e-4, "loss": 1e-5}
# pipeline_estimator_minibatch: a keras2 MLP at the fraud MLP's widths (29
# features, 256-256-1) through pipeline.estimator.Estimator, SGD with
# momentum and L2-norm clipping at 1.0, 20 train_minibatch steps of 1,024
# rows, card against the CPU from the same weights. Limits: parameters
# (each leaf's largest difference relative to its largest entry) at 1e-5,
# reading 1.6e-7 on an H100 80GB HBM3 at 700 W; the steps' losses at
# 1e-6, reading 8.1e-8; the control, one step fewer on the card, reads
# 0.095 on the parameters and must miss.
PIPELINE_EST = dict(rows=1024, features=29, widths=(256, 256), steps=20,
                    lr=0.05, momentum=0.9, clip=1.0, seed=0)
TOL_PIPELINE_EST = {"param": 1e-5, "loss": 1e-6}


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _tfpark_net(cfg, dev, n_block=None, drop=None):
    """The main path's model: a keras Sequential of the v1
    TransformerLayer and the keras2 head."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
        TransformerLayer
    from analytics_zoo_tpu_torch.pipeline.api.keras2 import layers as K2
    drop = cfg["drop"] if drop is None else drop
    torch.manual_seed(cfg["seed"])
    return Sequential([
        TransformerLayer(vocab=cfg["vocab"], seq_len=cfg["seq_len"],
                         n_block=n_block or cfg["n_block"],
                         n_head=cfg["n_head"], hidden_size=cfg["hidden"],
                         hidden_drop=drop, attn_drop=drop,
                         embedding_drop=drop, mask_attention=True,
                         strategy="flash"),
        K2.GlobalAveragePooling1D(), K2.Dropout(rate=drop),
        K2.Dense(units=cfg["classes"], activation="softmax")], device=dev)


def _tfpark_model(net, cfg, dev):
    from analytics_zoo_tpu_torch import tfpark
    from analytics_zoo_tpu_torch.orca.learn.optimizers import Adam
    return tfpark.KerasModel(
        net, loss="sparse_categorical_crossentropy",
        optimizer=tfpark.ZooOptimizer(Adam(lr=cfg["lr"]),
                                      grad_accum_steps=cfg["accum"]),
        device=dev)


def _tfpark_corpus(root, cfg):
    """The news20-layout corpus of ``cfg["docs"]`` documents through
    TextSet, cut to ``seq_len`` ids; (text set, host seconds)."""
    from analytics_zoo_tpu_torch.feature.text import TextSet
    t0 = time.perf_counter()
    news, _, _ = news20_corpus(root, dict(NEWS20, docs=cfg["docs"]))
    ts = TextSet.read(news)
    ts.tokenize()
    ts.normalize()
    ts.word2idx(remove_topN=NEWS20["remove_top"],
                max_words_num=NEWS20["max_words"])
    ts.shape_sequence(cfg["seq_len"])
    return ts, time.perf_counter() - t0


def tfpark_transformer_fit_phase(card, root, dev="cuda", cfg=TFPARK):
    """The main path (TFPARK): ``KerasModel.fit(TFDataset)`` for
    ``steps`` micro-steps with per-step CUDA-event times (steady samples/s
    from the median step after the first quarter), ``evaluate`` and
    ``predict`` on ``eval_docs`` documents; then ``profile_steps`` more
    micro-steps (two windows) in one ``fit`` under torch.profiler: the
    device's idle share over the whole call (``fit``'s set-up included)
    and over the span of its device work, and each flash kernel's device
    records (12 a micro-step expected, one per block). The fit runs
    unfused: the graph gate refuses ``ZooOptimizer``, and its reason must
    be in the fit's stats. Returns the dataset."""
    from analytics_zoo_tpu_torch import tfpark
    ts, host_s = _tfpark_corpus(root, cfg)
    ds = tfpark.TFDataset.from_text_set(ts, batch_size=cfg["batch"])
    held = tfpark.TFDataset.from_ndarrays(
        (ds.x[:cfg["eval_docs"]], ds.y[:cfg["eval_docs"]]))
    model = _tfpark_model(_tfpark_net(cfg, dev), cfg, dev)
    t0 = time.perf_counter()
    stats = model.fit(ds, epochs=1, steps_per_epoch=cfg["steps"],
                      profile=True, verbose=False)
    _sync(dev)
    fit_s = time.perf_counter() - t0
    est = model.estimator
    steady, step_ms = _steady_rate(stats, cfg["batch"])
    ev = model.evaluate(held, batch_per_thread=cfg["batch"])
    probs = model.predict(held, batch_per_thread=cfg["batch"])
    opt = est.engine.opt
    updates = opt.gradient_step
    prof, flash_records = None, None
    if torch.device(dev).type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            model.fit(ds, epochs=1, steps_per_epoch=cfg["profile_steps"],
                      verbose=False)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = _device_events(p)
        busy = _busy_ms(events)
        span = (max(e.time_range.end for e in events)
                - min(e.time_range.start for e in events)) / 1e3
        flash_records = _device_flash_launches(p)
        prof = {"wall_ms": wall_ms, "device_busy_ms": busy,
                "device_idle_share": 1.0 - busy / wall_ms,
                "device_span_ms": span,
                "device_idle_share_in_span": 1.0 - busy / span,
                "micro_steps": cfg["profile_steps"],
                "flash_device_records": flash_records,
                "flash_records_expected_each":
                    cfg["n_block"] * cfg["profile_steps"]}
    params = sum(p.numel() for p in est.module.parameters())
    reason = stats[-1].get("unfused_reason")
    emit({"phase": "tfpark_transformer_fit", "nvidia_smi": card,
          "config": cfg, "host_corpus_s": host_s, "docs": len(ds.x),
          "x_shape": list(ds.x.shape), "parameters": params,
          "fit_s": fit_s, "steady_samples_per_s": steady,
          "steady_step_ms": step_ms,
          "steady_tokens_per_s": steady * cfg["seq_len"],
          "step_ms": stats[-1]["profile"]["step_ms"],
          "train_loss": stats[-1]["train_loss"], "updates": updates,
          "fuse": est.fuse, "unfused_reason": reason,
          "eval_fuse": est.eval_fuse, "eval": ev, "predict_shape": list(np.shape(probs)),
          "profiled_window": prof})
    if not (math.isfinite(stats[-1]["train_loss"]) and np.isfinite(
            probs).all() and np.shape(probs) == (cfg["eval_docs"],
                                                 cfg["classes"])):
        fail(f"tfpark_transformer_fit: loss {stats[-1]['train_loss']}, "
             f"predictions {np.shape(probs)}")
    if updates != cfg["steps"] // cfg["accum"] or opt.mini_step != 0:
        fail(f"tfpark_transformer_fit: {updates} updates after "
             f"{cfg['steps']} micro-steps of ZooOptimizer(k="
             f"{cfg['accum']})")
    if torch.device(dev).type == "cuda":
        if est.fuse != 1 or not reason or "MultiSteps" not in reason:
            fail(f"tfpark_transformer_fit: fuse {est.fuse}, reason "
                 f"{reason!r}: ZooOptimizer must train unfused, saying so")
        if not all(flash_records.values()):
            fail(f"tfpark_transformer_fit: the profiler saw no flash "
                 f"kernel on the card: {flash_records}")
    return ds


def tfpark_vs_cpu_phase(card, ds, dev="cuda", cfg=TFPARK):
    """TFPARK_VS_CPU: the main path's model cut to 2 blocks, dropout 0,
    on the card and on the CPU from the same weights through KerasModel
    and ZooOptimizer, 8 micro-steps of batch 4 (2 windows, no shuffle)
    over the main path's first documents (``ds``, its TFDataset):
    the micro-steps' losses and the predictions on a probe batch, each
    relative to its largest magnitude. The control, the card with one
    window fewer (4 micro-steps) against the CPU's 8, must miss both
    limits (its probe predictions come from one update fewer)."""
    from analytics_zoo_tpu_torch import tfpark
    c = TFPARK_VS_CPU
    n = c["steps"] * c["batch"]
    x, y = ds.x[:n], ds.y[:n]
    probe = ds.x[n:n + c["batch"]]

    def run(device, steps, state=None):
        net = _tfpark_net(cfg, device, n_block=c["n_block"], drop=0.0)
        module = net.to_module()
        with torch.no_grad():                   # sizes the lazy head
            module.eval()(torch.from_numpy(x[:1]))
        if state is not None:
            module.load_state_dict(state)
        start = {k: v.detach().cpu().clone()
                 for k, v in module.state_dict().items()}
        model = _tfpark_model(net, cfg, device)
        losses = []
        for i in range(steps):
            part = tfpark.TFDataset.from_ndarrays(
                (x[i * c["batch"]:(i + 1) * c["batch"]],
                 y[i * c["batch"]:(i + 1) * c["batch"]]),
                batch_size=c["batch"])
            losses.append(model.fit(part, epochs=1, shuffle=False,
                                    verbose=False)[-1]["train_loss"])
        return start, np.asarray(losses), model.predict(
            probe, batch_per_thread=c["batch"])

    state, cpu_losses, cpu_probs = run("cpu", c["steps"])
    _, card_losses, card_probs = run(dev, c["steps"], state)
    _, _, ctl_probs = run(dev, c["steps"] - cfg["accum"], state)

    def rel(a, b):
        return float(np.abs(np.asarray(a, np.float64) - b).max()
                     / max(float(np.abs(b).max()), 1e-30))
    reading = {"loss": rel(card_losses, cpu_losses),
               "probs": rel(card_probs, cpu_probs)}
    control = {"probs": rel(ctl_probs, cpu_probs)}
    ok = (all(reading[k] <= TOL_TFPARK_VS_CPU[k] for k in reading)
          and control["probs"] > TOL_TFPARK_VS_CPU["probs"])
    emit({"phase": "tfpark_vs_cpu", "nvidia_smi": card, "config": c,
          "reading": reading, "control_one_window_fewer": control,
          "limits": TOL_TFPARK_VS_CPU,
          "card_losses": card_losses.tolist(),
          "cpu_losses": cpu_losses.tolist(), "ok": ok})
    if not ok:
        fail(f"tfpark_vs_cpu: reading {reading}, control {control}, "
             f"limits {TOL_TFPARK_VS_CPU}")


def synthetic_digits(n, size=16, seed=0):
    """examples/gan/mnist_gan.py's digit-ish images in [-1, 1]: a dark
    field and one bright vertical or horizontal stroke, (n, size, size,
    1)."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(n, size, size, 1).astype(np.float32) * 0.1
    for i in range(n):
        if rng.rand() < 0.5:
            c = rng.randint(3, size - 3)
            imgs[i, :, c - 1:c + 1, 0] += 0.8
        else:
            r = rng.randint(3, size - 3)
            imgs[i, r - 1:r + 1, :, 0] += 0.8
    return np.clip(imgs, 0, 1) * 2 - 1


class GanGenerator(torch.nn.Module):
    """mnist_gan.py's generator (flax layout, channels last): Dense 256,
    Dense 4*4*32, two stride-2 ConvTransposes (flax's, kernel not
    flipped), tanh."""

    def __init__(self, noise=32):
        super().__init__()
        from analytics_zoo_tpu_torch.pipeline.api.keras.layers.convolutional \
            import FlaxConvTranspose
        from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import \
            FlaxLinear
        self.Dense_0 = FlaxLinear(256)
        self.Dense_1 = FlaxLinear(4 * 4 * 32)
        self.ConvTranspose_0 = FlaxConvTranspose(16, (4, 4), (2, 2))
        self.ConvTranspose_1 = FlaxConvTranspose(1, (4, 4), (2, 2))
        self.forward(torch.zeros(1, noise))       # sizes the lazy widths

    def forward(self, z):
        h = torch.relu(self.Dense_0(z))
        h = torch.relu(self.Dense_1(h)).reshape(-1, 4, 4, 32)
        h = torch.relu(self.ConvTranspose_0(h.permute(0, 3, 1, 2)))
        return torch.tanh(self.ConvTranspose_1(h)).permute(0, 2, 3, 1)


class GanDiscriminator(torch.nn.Module):
    """mnist_gan.py's discriminator: two stride-2 SAME convs with leaky
    ReLU (slope 0.01, flax's), flattened channels last, Dense 1."""

    def __init__(self, size=16):
        super().__init__()
        from analytics_zoo_tpu_torch.pipeline.api.keras.layers.convolutional \
            import FlaxConv
        from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import \
            FlaxLinear
        self.Conv_0 = FlaxConv(16, (4, 4), (2, 2), in_features=1)
        self.Conv_1 = FlaxConv(32, (4, 4), (2, 2), in_features=16)
        self.Dense_0 = FlaxLinear(1)
        self.forward(torch.zeros(1, size, size, 1))

    def forward(self, x):
        leaky = torch.nn.functional.leaky_relu
        h = leaky(self.Conv_0(x.permute(0, 3, 1, 2)), 0.01)
        h = leaky(self.Conv_1(h), 0.01).permute(0, 2, 3, 1)
        return self.Dense_0(h.reshape(h.shape[0], -1))


def _gan(dev, cfg=GAN):
    from analytics_zoo_tpu_torch.orca.learn.gan_estimator import GANEstimator
    torch.manual_seed(cfg["seed"])
    return GANEstimator(GanGenerator(cfg["noise"]),
                        GanDiscriminator(cfg["size"]),
                        noise_dim=cfg["noise"], generator_optimizer="adam",
                        discriminator_optimizer="adam", seed=cfg["seed"],
                        device=dev)


def gan_fit_phase(card, dev="cuda", cfg=GAN):
    """examples/gan/mnist_gan.py on the port: ``GANEstimator.train`` for
    ``epochs`` epochs of batch 128 over 4,096 digits, then ``generate(256)``:
    the D and G steps' times (CUDA events around each step of one
    timed epoch), the pixel statistics the example prints and its gate
    (the generated mean closes more than a quarter of the gap from its
    tanh init's ~0 to the data's)."""
    real = synthetic_digits(cfg["rows"], cfg["size"], cfg["seed"])
    gan = _gan(dev, cfg)
    t0 = time.perf_counter()
    stats = gan.train({"x": real}, epochs=cfg["epochs"] - 1,
                      batch_size=cfg["batch"], verbose=False)
    _sync(dev)
    # the last epoch timed step by step
    d_ms, g_ms = [], []
    d_step, g_step = gan.d_step, gan.g_step

    def timed(fn, out):
        def run(*a):
            if torch.device(dev).type != "cuda":
                t = time.perf_counter()
                r = fn(*a)
                out.append((time.perf_counter() - t) * 1e3)
                return r
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            r = fn(*a)
            e.record()
            out.append((s, e))
            return r
        return run
    gan.d_step, gan.g_step = timed(d_step, d_ms), timed(g_step, g_ms)
    stats += gan.train({"x": real}, epochs=1, batch_size=cfg["batch"],
                       verbose=False)
    _sync(dev)
    train_s = time.perf_counter() - t0
    gan.d_step, gan.g_step = d_step, g_step
    if torch.device(dev).type == "cuda":
        d_ms = [s.elapsed_time(e) for s, e in d_ms]
        g_ms = [s.elapsed_time(e) for s, e in g_ms]
    samples = gan.generate(256)
    real_mean, fake_mean = float(real.mean()), float(samples.mean())
    real_std, fake_std = float(real.std()), float(samples.std())
    gate = abs(fake_mean - real_mean) < 0.75 * abs(real_mean)
    ok = (samples.shape == (256, cfg["size"], cfg["size"], 1)
          and bool(np.isfinite(samples).all()) and gate
          and all(math.isfinite(s["g_loss"]) and math.isfinite(s["d_loss"])
                  for s in stats))
    steps = len(stats) * math.ceil(cfg["rows"] / cfg["batch"])
    emit({"phase": "gan_fit", "nvidia_smi": card, "config": cfg,
          "train_s": train_s, "alternations": steps,
          "d_step_ms_median": statistics.median(d_ms),
          "g_step_ms_median": statistics.median(g_ms),
          "alternations_per_s": steps / train_s,
          "g_loss": [s["g_loss"] for s in stats][-3:],
          "d_loss": [s["d_loss"] for s in stats][-3:],
          "pixel_stats": {"real_mean": real_mean, "real_std": real_std,
                          "generated_mean": fake_mean,
                          "generated_std": fake_std},
          "example_gate": gate, "ok": ok})
    if not ok:
        fail(f"gan_fit: samples {samples.shape}, generated mean "
             f"{fake_mean} against real {real_mean} (gate {gate})")


def gan_vs_cpu_phase(card, dev="cuda", cfg=GAN):
    """GAN_VS_CPU: the same generator and discriminator on the card and on
    the CPU (the CPU's weights copied), ``alternations`` D+G steps on the
    first batches with the same noise (drawn on the CPU and handed to
    ``d_step``/``g_step``): each parameter leaf's largest difference
    relative to its largest entry, and the losses relative. The control,
    the card with one alternation fewer against the CPU's, must miss the
    parameter limit."""
    n = GAN_VS_CPU["alternations"]
    real = torch.from_numpy(synthetic_digits(n * cfg["batch"], cfg["size"],
                                             cfg["seed"] + 1))
    gen = torch.Generator().manual_seed(cfg["seed"] + 2)
    noise = [torch.randn(cfg["batch"], cfg["noise"], generator=gen)
             for _ in range(2 * n)]

    def run(device, alternations, state=None):
        gan = _gan(device, cfg)
        if state is not None:
            gan.generator.load_state_dict(state[0])
            gan.discriminator.load_state_dict(state[1])
        start = [{k: v.detach().cpu().clone() for k, v in
                  m.state_dict().items()}
                 for m in (gan.generator, gan.discriminator)]
        losses = []
        for i in range(alternations):
            batch = real[i * cfg["batch"]:(i + 1) * cfg["batch"]]
            losses.append(float(gan.d_step(batch.to(device), None,
                                           noise[2 * i].to(device))))
            losses.append(float(gan.g_step(noise[2 * i + 1].to(device))))
        end = {f"{tag}.{k}": v.detach().cpu() for tag, m in
               (("G", gan.generator), ("D", gan.discriminator))
               for k, v in m.state_dict().items()}
        return start, np.asarray(losses), end

    state, cpu_losses, cpu_end = run("cpu", n)
    _, card_losses, card_end = run(dev, n, state)
    _, _, ctl_end = run(dev, n - 1, state)
    reading = {"param": _param_rel(card_end, cpu_end),
               "loss": float(np.abs(card_losses - cpu_losses).max()
                             / np.abs(cpu_losses).max())}
    control = {"param": _param_rel(ctl_end, cpu_end)}
    ok = (all(reading[k] <= TOL_GAN_VS_CPU[k] for k in reading)
          and control["param"] > TOL_GAN_VS_CPU["param"])
    emit({"phase": "gan_vs_cpu", "nvidia_smi": card,
          "config": GAN_VS_CPU, "reading": reading,
          "control_one_alternation_fewer": control,
          "limits": TOL_GAN_VS_CPU, "ok": ok})
    if not ok:
        fail(f"gan_vs_cpu: reading {reading}, control {control}, limits "
             f"{TOL_GAN_VS_CPU}")


def pipeline_estimator_minibatch_phase(card, dev="cuda", cfg=PIPELINE_EST):
    """PIPELINE_EST: ``Estimator(keras2 MLP, SGD)`` with
    ``set_l2_norm_gradient_clipping`` on the card and on the CPU from the
    same weights, 20 ``train_minibatch`` steps each: every step's loss
    relative to the largest, each parameter leaf's largest difference
    relative to its largest entry. The control, the card with one step
    fewer, must miss the parameter limit. Also the card's step time."""
    from analytics_zoo_tpu_torch.orca.learn.optimizers import SGD
    from analytics_zoo_tpu_torch.pipeline.api import keras2
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    rng = np.random.RandomState(cfg["seed"])
    x = rng.randn(cfg["rows"], cfg["features"]).astype(np.float32)
    y = (x[:, :3].sum(-1, keepdims=True) > 0).astype(np.float32)

    def run(device, steps, state=None):
        torch.manual_seed(cfg["seed"])
        net = keras2.Sequential(
            [keras2.layers.Dense(w, activation="relu")
             for w in cfg["widths"]]
            + [keras2.layers.Dense(1, activation="sigmoid")], device=device)
        module = net.to_module()
        module(torch.from_numpy(x[:1]))           # sizes the lazy widths
        if state is not None:
            module.load_state_dict(state)
        est = Estimator(module, optim_methods=SGD(
            learningrate=cfg["lr"], momentum=cfg["momentum"]),
            device=device)
        est.set_l2_norm_gradient_clipping(cfg["clip"])
        start = {k: v.detach().cpu().clone()
                 for k, v in module.state_dict().items()}
        losses, t0 = [], time.perf_counter()
        for _ in range(steps):
            losses.append(est.train_minibatch(x, y,
                                              loss="binary_crossentropy"))
        took = time.perf_counter() - t0
        end = {k: v.detach().cpu() for k, v in module.state_dict().items()}
        return start, np.asarray(losses), end, took

    state, cpu_losses, cpu_end, _ = run("cpu", cfg["steps"])
    _, card_losses, card_end, card_s = run(dev, cfg["steps"], state)
    _, _, ctl_end, _ = run(dev, cfg["steps"] - 1, state)
    reading = {"param": _param_rel(card_end, cpu_end),
               "loss": float(np.abs(card_losses - cpu_losses).max()
                             / np.abs(cpu_losses).max())}
    control = {"param": _param_rel(ctl_end, cpu_end)}
    ok = (all(reading[k] <= TOL_PIPELINE_EST[k] for k in reading)
          and control["param"] > TOL_PIPELINE_EST["param"]
          and bool(cpu_losses[-1] < cpu_losses[0]))
    emit({"phase": "pipeline_estimator_minibatch", "nvidia_smi": card,
          "config": cfg, "reading": reading,
          "control_one_step_fewer": control, "limits": TOL_PIPELINE_EST,
          "card_steps_per_s": cfg["steps"] / card_s,
          "losses_first_last": [float(card_losses[0]),
                                float(card_losses[-1])], "ok": ok})
    if not ok:
        fail(f"pipeline_estimator_minibatch: reading {reading}, control "
             f"{control}, limits {TOL_PIPELINE_EST}")


def tfpark_paths(card):
    """The TF-migration slice's phases, each driven with the flash
    kernels' counts at 0: the main path must launch each kernel, the
    others none (their models hold no attention). Returns the counts by
    path."""
    from analytics_zoo_tpu_torch.ops import attention as at
    kernels = [getattr(at, name) for name in FLASH_KERNELS]
    launches, data = {}, {}
    root = tempfile.mkdtemp(prefix="tfpark-")
    try:
        for name, run in (
                ("tfpark_transformer_fit", lambda: data.update(
                    ds=tfpark_transformer_fit_phase(card, root))),
                ("tfpark_vs_cpu",
                 lambda: tfpark_vs_cpu_phase(card, data["ds"])),
                ("gan_fit", lambda: gan_fit_phase(card)),
                ("gan_vs_cpu", lambda: gan_vs_cpu_phase(card)),
                ("pipeline_estimator_minibatch",
                 lambda: pipeline_estimator_minibatch_phase(card))):
            for fn in kernels:
                fn.launches = 0
            run()
            launches[name] = {fn.__name__: fn.launches for fn in kernels}
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    main_path = launches.pop("tfpark_transformer_fit")
    if not all(main_path.values()):
        fail(f"tfpark_transformer_fit launched a flash kernel no time: "
             f"{main_path}")
    if any(n for name, counts in launches.items()
           if name != "tfpark_vs_cpu" for n in counts.values()):
        fail(f"a flash kernel launched on a GAN or pipeline path: "
             f"{launches}")
    return {"tfpark_transformer_fit": main_path, **launches}


# --- the streaming plane and the training supervisor -------------------------
# examples/streaming/online_ncf.py at NCF_WIDTHS: NeuralCF's module (6,040
# users, 3,706 items, 5 classes, embeddings 64, MLP 128/64/32, f32) under
# TPUEstimator(loss="sparse_categorical_crossentropy", Adam). A producer
# thread XADDs (user, item) -> rating-class records to MiniRedisServer
# through RedisBroker; every other record comes from the probe user 0, who
# gives item 0 a 4 and item 1 a 0 until the stream's midpoint and the
# reverse after (the example's drift), the rest are uniform users, items
# and classes. StreamingXShards closes count windows of 4,096 records (4
# batches of 1,024): 8 windows, 32,768 records. That is the example at
# windows of 16,384 and batch 4,096 cut by 4: the Python MiniRedisServer
# moved 1,718 records/s through the phase on the card's host (a 16,384
# window took 9.3 s of ingest, the phase 78 s, the group 186 s; NVIDIA
# H100 80GB HBM3, 700 W). lr 0.05: each record is seen once, and the
# point is to follow the drift within a few windows. A fifth of the
# probe's ratings are noise (see _stream_arrays): with clean ones the
# card's softmax saturated below the loss's 1e-7 clip by window 4 and the
# drifted labels brought no gradient (the ranking never turned); with them
# a CPU run reads expected ratings 3.61 / 0.42 after window 4 and 0.14 /
# 3.44 after window 8, the smallest probability 0.005. Adam at this lr
# turns the rounding of near-zero gradients into lr-sized steps: with
# index_add_'s float atomics two runs of the same windows read 0.24 apart
# (16,384-record windows, the one-window-on control 0.40), so the group
# runs under torch.use_deterministic_algorithms (warn_only), whose
# index_add_ sums in a fixed order (then 0.0). The records travel through a broker
# host process (_BrokerHost): a MiniRedisServer and the producer threads.
# The fleet's windows are 2,048 (2 batches), 2 a partition. The guard leg
# trains the linear factory (dim 8, lr 0.01, gradients clipped to norm 1)
# on windows of 1,024 (32 steps): 4 clean windows, one with its labels
# scaled by 100, then clean windows until one is adopted (at most 4). Adam
# carries the poisoned window's gradients into the next window's steps
# through its moments, so the commits right after it still regress on
# the holdout and are rejected too (holdout losses on the card: 0.80,
# 0.064, 3.2e-4, 5.3e-5, poisoned 0.71, then 0.15, 2.3e-3 and 7.6e-5,
# adopted); the clipping keeps that tail to a few windows. The supervised
# fit is NCF on 8,192 rows of bench_ncf's pairs (8 steps an epoch, 4
# epochs).
STREAM = dict(batch=1024, window=4096, windows=8, lr=0.05, poll_s=0.1,
              seed=19, fused_windows=3, fused_k=4, resume_windows=2,
              linear_batch=256, linear_window=1024, fleet_window=2048,
              fleet_windows=2, guard_batch=32, guard_window=1024,
              guard_lr=0.01, guard_clip=1.0, guard_poison=100.0,
              guard_clean=4, guard_recover=4, sup_rows=8192,
              sup_epochs=4, sup_timeout_s=2.0, sup_stall_s=3.0)
# A predict that ran while the reloader swapped weights answers with one
# adopted state's weights: its probe outputs within this of that state's
# own (the same module and batch on the card: the same kernels).
TOL_SWAP_READ = 1e-6
# The SIGTERM-resumed NCF stream against the uninterrupted one (the online
# run's checkpoint after the same windows), and the supervised NCF fit
# against an unsupervised one: the largest parameter difference relative
# to that parameter's largest entry, as TOL_GRAPH (index_add_ atomics make
# two eager runs differ). Controls: the uninterrupted run one window on,
# the unsupervised run one epoch short, must miss. The linear model has no
# atomics and is held bit for bit.
TOL_STREAM_RESUME = 1e-5
TOL_SUPERVISED = 1e-5


def _stream_arrays(n, cfg=STREAM):
    """The online NCF stream's first ``n`` records as arrays: pairs (n, 2)
    int32 and rating classes (n,) int32; the drift at the full stream's
    midpoint, whatever ``n`` (drawn for the whole stream, then cut)."""
    rng = np.random.RandomState(cfg["seed"])
    total = cfg["window"] * cfg["windows"]
    pairs = np.stack([rng.randint(1, NCF_WIDTHS["user_count"] + 1, total),
                      rng.randint(1, NCF_WIDTHS["item_count"] + 1, total)],
                     -1).astype(np.int32)[:n]
    labels = rng.randint(0, 5, total).astype(np.int32)[:n]
    noisy = (rng.rand(total) < 0.2)[:n]
    i = np.arange(0, n, 2)
    item = (i // 2) % 2
    loved = np.where(i < total // 2, 0, 1)
    pairs[i, 0], pairs[i, 1] = 0, item
    # a fifth of the probe's ratings are the background's uniform class:
    # the softmax then never saturates past the loss's 1e-7 clip, under
    # which the drifted labels would bring no gradient
    labels[i] = np.where(noisy[i], labels[i], np.where(item == loved, 4, 0))
    return pairs, labels


class _Producer(threading.Thread):
    """XADDs records [lo, hi) of (x, y) arrays through ``broker`` in stream
    order, each stamped with its event time as it is sent; ``keyed``
    stamps the row's user (column 0) as its partition key."""

    def __init__(self, broker, x, y, lo, hi, first_id=None, keyed=False):
        super().__init__(name="stream-producer", daemon=True)
        self.broker, self.x, self.y = broker, x, y
        self.lo, self.hi, self.keyed = lo, hi, keyed
        self.first_id = lo if first_id is None else first_id
        self.error = None

    def run(self):
        from analytics_zoo_tpu_torch.streaming import encode_record, seq_id
        try:
            for i in range(self.lo, self.hi):
                self.broker.enqueue(seq_id(self.first_id + i - self.lo),
                                    encode_record(
                    self.x[i], self.y[i], event_time=time.time(),
                    key=f"user:{int(self.x[i][0])}" if self.keyed
                    else None))
        except Exception as e:      # noqa: BLE001 — reported by "join"
            self.error = repr(e)


def _broker_host_main(conn):
    """The streaming phases' broker host (a spawned process): a
    MiniRedisServer, and the producer threads the parent asks for over
    ``conn``, each with its own RedisBroker. The broker's and the
    producers' Python work then does not share the trainer's interpreter
    (in one process the XADD and XREADGROUP round trips held the ingest
    near 900 records/s on the card's host)."""
    from analytics_zoo_tpu_torch.serving.queue_api import (RedisBroker,
                                                           make_broker)
    from analytics_zoo_tpu_torch.serving.redis_protocol import \
        MiniRedisServer
    srv = MiniRedisServer(port=0).start()
    conn.send((srv.host, srv.port))
    producers = {}
    try:
        while True:
            msg = conn.recv()
            if msg[0] == "produce":
                _, tag, target, x, y, lo, hi, first_id, keyed = msg
                broker = (make_broker(target) if "://" in target
                          else RedisBroker(srv.host, srv.port,
                                           stream=target, group="train"))
                producers[tag] = _Producer(broker, x, y, lo, hi, first_id,
                                           keyed)
                producers[tag].start()
            elif msg[0] == "join":
                prod = producers.pop(msg[1])
                prod.join(msg[2])
                conn.send(prod.error if not prod.is_alive()
                          else "still running")
            else:
                break
    finally:
        srv.stop()


class _BrokerHost:
    """The parent's handle on ``_broker_host_main``: ``host``/``port`` of
    its MiniRedisServer, ``produce`` (returns a handle whose ``finish``
    waits for the records to be sent), ``stop``."""

    def __init__(self):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_broker_host_main, args=(child,),
                                 daemon=True, name="stream-broker-host")
        self._proc.start()
        if not self._conn.poll(120):
            self.stop()
            fail("the streaming broker host never started")
        self.host, self.port = self._conn.recv()
        self._tags = 0

    def produce(self, target, x, y, lo, hi, first_id=None, keyed=False):
        """Send rows [lo, hi) to ``target``: a stream name (group
        "train") or a broker spec (a partitioned router)."""
        self._tags += 1
        self._conn.send(("produce", self._tags, target, x, y, lo, hi,
                         first_id, keyed))
        return _Produced(self, self._tags)

    def join(self, tag, timeout_s):
        self._conn.send(("join", tag, timeout_s))
        err = self._conn.recv()
        if err is not None:
            fail(f"stream producer: {err}")

    def stop(self):
        try:
            self._conn.send(("stop",))
        except (OSError, ValueError):
            pass
        self._proc.join(10)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(5)


class _Produced:
    def __init__(self, host, tag):
        self.host, self.tag = host, tag

    def finish(self, timeout_s=300):
        self.host.join(self.tag, timeout_s)


def _wait_for(cond, timeout_s, what):
    deadline = time.time() + timeout_s
    while not cond():
        if time.time() > deadline:
            fail(f"timed out waiting for {what}")
        time.sleep(0.01)


def _stream_ncf_estimator(dev, model_dir=None, config=None):
    """NeuralCF's module at NCF_WIDTHS (seed 0: the same weights every
    call) under the online example's estimator; module-level, so a fleet
    consumer's factory pickles across the spawn boundary."""
    from analytics_zoo_tpu_torch.models.recommendation.neuralcf import \
        NeuralCFNet
    from analytics_zoo_tpu_torch.orca.learn.estimator import TPUEstimator
    from analytics_zoo_tpu_torch.orca.learn.optimizers import Adam
    return TPUEstimator(NeuralCFNet(**NCF_WIDTHS),
                        loss="sparse_categorical_crossentropy",
                        optimizer=Adam(lr=STREAM["lr"]), model_dir=model_dir,
                        config=dict(config or {}), device=dev)


def _counted_stream_estimator(report_dir, factory):
    """A fleet consumer's estimator factory whose process reports its own
    kernel launches after each window's ``fit`` (``_report_launches``)."""
    est = factory()
    _report_launches(report_dir, est, method="fit")
    return est


_PROBE = np.array([[0, 0], [0, 1]], np.int32)     # user 0 x items 0 / 1


def _probe_scores(model):
    """The served expected rating of the probe user for items 0 and 1."""
    probs = model.predict(_PROBE)
    return [float(v) for v in probs @ np.arange(5, dtype=np.float32)]


def _ckpt_params(model_dir, step):
    from analytics_zoo_tpu_torch.ckpt import format as fmt
    state = fmt.load_checkpoint_dir(os.path.join(model_dir, f"ckpt-{step}"))
    return {k: torch.from_numpy(np.array(v))
            for k, v in state["params"].items()}


def _est_params(est):
    return {k: v.detach().cpu().clone()
            for k, v in est.module.state_dict().items()}


def streaming_ncf_online_phase(card, root, srv, dev="cuda", cfg=STREAM):
    """The main path: the online example at NCF_WIDTHS. The trainer runs
    one window a call, and the served copy's StreamingReloader (its own
    thread, poll ``poll_s``) must adopt each commit before the next
    window: 8 reloads. Prints records/s trained over the 8 windows' wall
    time (ingest from the live producer included), the median window's
    train and commit seconds, freshness p50/p99 (newest trained event ->
    adopted), reloads, captures after window 1, and the probe's served
    expected ratings cold, at the drift (after window 4) and at the end;
    the ranking must flip, and a served copy without a reloader (the
    control) keeps its ranking. Returns the run's model_dir (the
    checkpoint after every window: the eager reference of later phases)."""
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving.queue_api import RedisBroker
    from analytics_zoo_tpu_torch.streaming import (StreamingReloader,
                                                   StreamingTrainer,
                                                   StreamingXShards)
    total = cfg["window"] * cfg["windows"]
    t_gen = time.perf_counter()
    pairs, labels = _stream_arrays(total, cfg)
    gen_s = time.perf_counter() - t_gen
    d = os.path.join(root, "online")
    est = _stream_ncf_estimator(dev, d)
    served = InferenceModel(device=dev).load_module(
        copy.deepcopy(est.module))
    control = InferenceModel(device=dev).load_module(
        copy.deepcopy(est.module))
    src = StreamingXShards(
        RedisBroker(srv.host, srv.port, stream="ncf", group="train"),
        batch_size=cfg["batch"], window_records=cfg["window"],
        window_age_s=600.0, poll_timeout_s=0.05)
    tr = StreamingTrainer(est, src, d)
    rel = StreamingReloader(served, d, poll_s=cfg["poll_s"],
                            start_at=-1, stats=src.stats)
    cold = _probe_scores(served)
    rel.start()
    prod = srv.produce("ncf", pairs, labels, 0, total)
    windows, mid, mid_control = [], None, None
    t0 = time.perf_counter()
    for k in range(cfg["windows"]):
        before = src.stats.snapshot()
        tr.run(max_windows=1, idle_timeout_s=60.0)
        after = src.stats.snapshot()
        if after["windows"] != k + 1:
            fail(f"streaming_ncf_online: window {k + 1} did not close")
        _wait_for(lambda: rel.reload_count >= k + 1, 30,
                  f"the reloader to adopt window {k + 1}")
        windows.append({key: after[key] - before[key] for key in (
            "ingest_s", "assemble_s", "train_s", "commit_s")})
        windows[-1]["records_per_s"] = after["last_records_per_s"]
        if k + 1 == cfg["windows"] // 2:
            mid = _probe_scores(served)
            mid_control = _probe_scores(control)
    wall = time.perf_counter() - t0
    prod.finish()
    end = _probe_scores(served)
    end_control = _probe_scores(control)
    rel.stop()
    snap = src.stats.snapshot()
    p50, p99 = rel.freshness_percentiles()
    recompiles = tr.recompiles_after_warm()
    cursor = tr.cursor.to_dict()
    est.shutdown()
    src.close()
    med = {key: statistics.median(w[key] for w in windows)
           for key in ("ingest_s", "train_s", "commit_s")}
    flipped = mid[0] > mid[1] and end[1] > end[0]
    control_flipped = (mid_control[0] > mid_control[1]) != \
        (end_control[0] > end_control[1])
    emit({"phase": "streaming_ncf_online", "nvidia_smi": card,
          "config": cfg, "widths": NCF_WIDTHS, "records": total,
          "host_records_s": gen_s,
          "records_per_s_trained": snap["records_trained"] / wall,
          "wall_s": wall, "median_window_train_s": med["train_s"],
          "median_window_commit_s": med["commit_s"],
          "median_window_ingest_s": med["ingest_s"], "windows": windows,
          "freshness_p50_s": p50, "freshness_p99_s": p99,
          "reloads": snap["reloads"],
          "recompiles_after_warm": recompiles, "cursor": cursor,
          "probe_expected_rating": {"cold": cold, "after_window_4": mid,
                                    "end": end},
          "control_expected_rating": {"after_window_4": mid_control,
                                      "end": end_control},
          "ranking_flipped": flipped,
          "control_ranking_flipped": control_flipped})
    if snap["windows"] != cfg["windows"] or \
            snap["records_trained"] != total or \
            snap["reloads"] != cfg["windows"]:
        fail(f"streaming_ncf_online: {snap['windows']} windows, "
             f"{snap['records_trained']} records, {snap['reloads']} "
             f"reloads")
    if recompiles != 0 or p50 is None or p99 is None:
        fail(f"streaming_ncf_online: {recompiles} captures after window 1, "
             f"freshness {p50} / {p99}")
    if not all(math.isfinite(v) for v in cold + mid + end):
        fail(f"streaming_ncf_online: served scores {cold} {mid} {end}")
    if not flipped or control_flipped:
        fail(f"streaming_ncf_online: the probe's ranking {mid} -> {end} "
             f"(must flip), the control's {mid_control} -> {end_control} "
             f"(must not)")
    return {"model_dir": d, "steps_per_window": cfg["window"] // cfg["batch"]}


def streaming_fused_windows_phase(card, root, online, srv, dev="cuda",
                                  cfg=STREAM):
    """The online loop's first ``fused_windows`` windows at
    ``steps_per_dispatch`` pinned to ``fused_k`` (a window is one fused
    group): window 1 captures the one train graph (its group runs eagerly,
    then is captured) and later windows replay it. A thread predicts the
    probe batch on a served copy all along while its reloader swaps each
    commit in: every answer must be one adopted state's (TOL_SWAP_READ),
    never a half-swapped module's. The fused weights are held against the
    online (eager) run's after as many windows within TOL_GRAPH["ncf"];
    the control, the eager run one window on, must miss."""
    from analytics_zoo_tpu_torch.orca.learn import graphs
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving.queue_api import RedisBroker
    from analytics_zoo_tpu_torch.streaming import (StreamingReloader,
                                                   StreamingTrainer,
                                                   StreamingXShards)
    n = cfg["window"] * cfg["fused_windows"]
    pairs, labels = _stream_arrays(n, cfg)
    d = os.path.join(root, "fused")
    probe = np.concatenate([_PROBE, pairs[:62]])     # one 64-row bucket
    seen, stop = [], threading.Event()
    try:
        est = _stream_ncf_estimator(dev, d, {"steps_per_dispatch":
                                             cfg["fused_k"]})
        init = copy.deepcopy(est.module)
        served = InferenceModel(device=dev).load_module(
            copy.deepcopy(est.module))
        src = StreamingXShards(
            RedisBroker(srv.host, srv.port, stream="fused", group="train"),
            batch_size=cfg["batch"], window_records=cfg["window"],
            window_age_s=600.0, poll_timeout_s=0.05)
        tr = StreamingTrainer(est, src, d)
        rel = StreamingReloader(served, d, poll_s=0.05, start_at=-1).start()

        def predict_loop():
            while not stop.is_set():
                seen.append(served.predict(probe))

        reader = threading.Thread(target=predict_loop, daemon=True,
                                  name="stream-reader")
        captures0, replays0 = graphs.CAPTURES["train"], \
            graphs.REPLAYS["train"]
        reader.start()
        prod = srv.produce("fused", pairs, labels, 0, n)
        tr.run(max_windows=1, idle_timeout_s=60.0)
        captures1 = graphs.CAPTURES["train"]
        tr.run(max_windows=cfg["fused_windows"] - 1, idle_timeout_s=60.0)
        prod.finish()
        steps = est.engine.step
        _wait_for(lambda: rel.reload_count >= 1 and
                  served.ckpt_stats().get("last_reload_step") == steps, 30,
                  "the reloader to adopt the last window")
        time.sleep(0.1)             # the reader reads the last weights too
        stop.set()
        reader.join(30)
        rel.stop()
        captures = {"in_window_1": captures1 - captures0,
                    "after_window_1": graphs.CAPTURES["train"] - captures1}
        replays = graphs.REPLAYS["train"] - replays0
        fused = _est_params(est)
        fuse, recompiles = est.fuse, tr.recompiles_after_warm()
        est.shutdown()
        src.close()
        # what the reader may have seen: the initial weights and each
        # committed window's, answered on the card by the same module
        spw = online["steps_per_window"]
        states = [None] + [spw * (w + 1) for w in range(cfg["fused_windows"])]
        expect = []
        for step in states:
            m = copy.deepcopy(init)
            if step is not None:
                m.load_state_dict(_ckpt_params(d, step))
            expect.append(InferenceModel(device=dev).load_module(m)
                          .predict(probe))
    finally:
        stop.set()
    dist = [min(float(np.abs(o - e).max()) for e in expect) for o in seen]
    which = sorted({int(np.argmin([np.abs(o - e).max() for e in expect]))
                    for o in seen})
    eager_dir = online["model_dir"]
    at = online["steps_per_window"] * cfg["fused_windows"]
    eager = _ckpt_params(eager_dir, at)
    rel_err = _max_param_rel(fused, eager)
    control = _max_param_rel(_ckpt_params(
        eager_dir, at + online["steps_per_window"]), eager)
    on_card = torch.device(dev).type == "cuda"
    emit({"phase": "streaming_fused_windows", "nvidia_smi": card,
          "windows": cfg["fused_windows"], "steps_per_dispatch": fuse,
          "captures": captures, "graph_replays": replays,
          "recompiles_after_warm": recompiles,
          "graph_vs_eager": rel_err, "control": control,
          "limit": TOL_GRAPH["ncf"], "concurrent_predicts": len(seen),
          "predict_worst_distance": max(dist) if dist else None,
          "predict_limit": TOL_SWAP_READ, "states_seen": which})
    if fuse != cfg["fused_k"] or recompiles != 0:
        fail(f"streaming_fused_windows: fuse {fuse}, {recompiles} captures "
             f"after window 1")
    if on_card and (captures != {"in_window_1": 1, "after_window_1": 0}
                    or replays != cfg["fused_windows"] - 1):
        fail(f"streaming_fused_windows: captures {captures}, {replays} "
             f"replays (one capture in window 1, a replay a later window)")
    if not rel_err <= TOL_GRAPH["ncf"] < control:
        fail(f"streaming_fused_windows: graph vs eager {rel_err}, control "
             f"{control}, limit {TOL_GRAPH['ncf']}")
    if not seen or max(dist) > TOL_SWAP_READ or len(which) < 2:
        fail(f"streaming_fused_windows: {len(seen)} concurrent predicts, "
             f"worst distance {max(dist) if dist else None} from an "
             f"adopted state, states seen {which}")


def _interrupted_stream(factory, x, y, n_first, n, batch, window, windows,
                        d, stream, srv):
    """Trains ``windows`` windows of (x, y) in ``d``, stopped by a SIGTERM
    (a preemption notice) while window 2 accumulates after ``n_first``
    records and resumed from ``d`` by a fresh estimator. Returns the
    resumed estimator's parameters and the two runs' stats."""
    from analytics_zoo_tpu_torch.serving.queue_api import RedisBroker
    from analytics_zoo_tpu_torch.streaming import (StreamingTrainer,
                                                   StreamingXShards)
    srv.produce(stream, x, y, 0, n_first).finish()
    est = factory(d)
    src = StreamingXShards(RedisBroker(srv.host, srv.port, stream=stream,
                                       group="train"),
                           batch_size=batch, window_records=window,
                           window_age_s=600.0, poll_timeout_s=0.05,
                           claim_size=window)
    tr = StreamingTrainer(est, src, d)

    def notice():
        _wait_for(lambda: src.stats.snapshot()["windows"] >= 1 and
                  src.stats.snapshot()["records_in"] >= n_first, 60,
                  "window 2 to accumulate")
        os.kill(os.getpid(), signal.SIGTERM)

    killer = threading.Thread(target=notice, daemon=True)
    killer.start()
    tr.run(max_windows=windows, idle_timeout_s=60.0)
    stopped = time.time()
    killer.join(60)
    first = src.stats.snapshot()
    est.shutdown()
    src.close()
    srv.produce(stream, x, y, n_first, n).finish()
    est2 = factory(d)
    # the resumed consumer's first claim takes back every unacked claim of
    # the stopped one (idle past the bound, one XAUTOCLAIM: claim_size
    # covers them) ahead of the fresh entries, so window 2 is composed in
    # stream order, as the uninterrupted run composed it
    time.sleep(max(0.0, 1.2 - (time.time() - stopped)))
    src2 = StreamingXShards(RedisBroker(srv.host, srv.port, stream=stream,
                                        group="train", claim_idle_ms=1000),
                            batch_size=batch, window_records=window,
                            window_age_s=600.0, poll_timeout_s=0.05,
                            claim_size=window)
    tr2 = StreamingTrainer(est2, src2, d)
    resumed = tr2.resume()
    cursor0 = tr2.cursor.window
    tr2.run(max_windows=windows - cursor0, idle_timeout_s=60.0)
    params = _est_params(est2)
    second = src2.stats.snapshot()
    est2.shutdown()
    src2.close()
    return params, {"windows_before_notice": first["windows"],
                    "resumed": resumed, "resumed_at_window": cursor0,
                    "windows_after": second["windows"],
                    "records_deduped": second["records_deduped"],
                    "records_trained": first["records_trained"]
                    + second["records_trained"]}


def streaming_resume_phase(card, root, online, srv, dev="cuda", cfg=STREAM):
    """A SIGTERM while window 2 accumulates stops the trainer (window 1
    committed, the half window unacked), and a fresh estimator resumes
    from model_dir and finishes: NCF against the online run's checkpoint
    after as many windows within TOL_STREAM_RESUME (control: that run one
    window on); the linear factory's model against an uninterrupted run
    of its records, bit for bit."""
    from analytics_zoo_tpu_torch.serving.queue_api import RedisBroker
    from analytics_zoo_tpu_torch.streaming import (StreamingTrainer,
                                                   StreamingXShards)
    from analytics_zoo_tpu_torch.streaming.fleet import \
        linear_estimator_factory
    wins = cfg["resume_windows"]
    n = cfg["window"] * wins
    pairs, labels = _stream_arrays(n, cfg)
    ncf, ncf_info = _interrupted_stream(
        lambda d: _stream_ncf_estimator(dev, d), pairs, labels,
        cfg["window"] + cfg["window"] // 2, n, cfg["batch"],
        cfg["window"], wins, os.path.join(root, "resume-ncf"), "rncf",
        srv)
    rng = np.random.RandomState(cfg["seed"])
    ln = cfg["linear_window"] * wins
    lx = rng.rand(ln, 8).astype(np.float32)
    ly = (lx @ (np.arange(8, dtype=np.float32) / 8)).astype(np.float32)
    lin_factory = partial(linear_estimator_factory, dim=8, device=dev)
    lin, lin_info = _interrupted_stream(
        lambda d: lin_factory(), lx, ly,
        cfg["linear_window"] + cfg["linear_window"] // 2, ln,
        cfg["linear_batch"], cfg["linear_window"], wins,
        os.path.join(root, "resume-linear"), "rlin", srv)
    # the linear model's uninterrupted run
    srv.produce("rlin-ref", lx, ly, 0, ln).finish()
    est = lin_factory()
    src = StreamingXShards(RedisBroker(srv.host, srv.port,
                                       stream="rlin-ref", group="train"),
                           batch_size=cfg["linear_batch"],
                           window_records=cfg["linear_window"],
                           window_age_s=600.0, poll_timeout_s=0.05)
    StreamingTrainer(est, src, os.path.join(root, "resume-lin-ref")).run(
        max_windows=wins, idle_timeout_s=60.0)
    lin_ref = _est_params(est)
    est.shutdown()
    src.close()
    spw = online["steps_per_window"]
    eager = _ckpt_params(online["model_dir"], spw * wins)
    rel_err = _max_param_rel(ncf, eager)
    control = _max_param_rel(_ckpt_params(online["model_dir"],
                                          spw * (wins + 1)), eager)
    lin_equal = all(torch.equal(lin[k], lin_ref[k]) for k in lin_ref)
    emit({"phase": "streaming_resume", "nvidia_smi": card, "windows": wins,
          "ncf": ncf_info, "ncf_vs_uninterrupted": rel_err,
          "ncf_control": control, "ncf_limit": TOL_STREAM_RESUME,
          "linear": lin_info, "linear_bit_identical": lin_equal})
    for info, window in ((ncf_info, cfg["window"]),
                         (lin_info, cfg["linear_window"])):
        if info["windows_before_notice"] != 1 or not info["resumed"] or \
                info["resumed_at_window"] != 1 or \
                info["records_trained"] != window * wins:
            fail(f"streaming_resume: {info}")
    if not rel_err <= TOL_STREAM_RESUME < control:
        fail(f"streaming_resume: NCF resumed vs uninterrupted {rel_err}, "
             f"control {control}, limit {TOL_STREAM_RESUME}")
    if not lin_equal:
        fail("streaming_resume: the resumed linear model is not the "
             "uninterrupted one bit for bit")


def _fleet_keyed_records(n_per, parts, seed):
    """Background NCF records keyed by user, ``n_per`` to each partition,
    in one id order: pairs, labels, partitions."""
    from analytics_zoo_tpu_torch.streaming import partition_for
    rng = np.random.RandomState(seed)
    users = np.arange(1, NCF_WIDTHS["user_count"] + 1)
    part = np.array([partition_for(f"user:{u}", parts) for u in users])
    rows, counts = [], [0] * parts
    while min(counts) < n_per:
        u = int(rng.choice(users))
        k = int(part[u - 1])
        if counts[k] < n_per:
            rows.append((u, rng.randint(1, NCF_WIDTHS["item_count"] + 1),
                         rng.randint(0, 5), k))
            counts[k] += 1
    a = np.array(rows)
    return (a[:, :2].astype(np.int32), a[:, 2].astype(np.int32),
            a[:, 3].astype(np.int32))


def _guard_leg(dev, root, srv, cfg):
    """The guardrail on the linear factory: clean windows are adopted, a
    window whose labels are scaled by ``guard_poison`` commits and is
    rejected (its step never reaches the served model), and a later clean
    window's commit is adopted (see STREAM's comment)."""
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving.queue_api import RedisBroker
    from analytics_zoo_tpu_torch.streaming import (FleetReloaders,
                                                   GuardrailEvaluator,
                                                   StreamingTrainer,
                                                   StreamingXShards,
                                                   module_loss_scorer)
    from analytics_zoo_tpu_torch.streaming.fleet import \
        linear_estimator_factory
    w_true = np.arange(8, dtype=np.float32) / 8
    rng = np.random.RandomState(cfg["seed"] + 1)
    est = linear_estimator_factory(dim=8, lr=cfg["guard_lr"], device=dev)
    est.set_l2_norm_gradient_clipping(cfg["guard_clip"])
    d = os.path.join(root, "guard")
    guard = GuardrailEvaluator(module_loss_scorer(copy.deepcopy(est.module)),
                               holdout_records=64, min_holdout=32,
                               regression=0.5, baseline_window=8)
    for _ in range(64):
        x = rng.normal(size=8).astype(np.float32)
        guard.observe(x, np.float32(x @ w_true))
    served = InferenceModel(device=dev).load_module(
        copy.deepcopy(est.module))
    fr = FleetReloaders({0: served}, d, poll_s=60, start_at=-1,
                        guards={0: guard})
    src = StreamingXShards(RedisBroker(srv.host, srv.port, stream="guard",
                                       group="train"),
                           batch_size=cfg["guard_batch"],
                           window_records=cfg["guard_window"],
                           window_age_s=600.0, poll_timeout_s=0.05)
    tr = StreamingTrainer(est, src, os.path.join(d, "p0"))
    seq = [0]

    def window(poison):
        x = rng.normal(size=(cfg["guard_window"], 8)).astype(np.float32)
        y = (x @ w_true) * (cfg["guard_poison"] if poison else 1.0)
        srv.produce("guard", x, y.astype(np.float32), 0, len(x),
                    first_id=seq[0]).finish()
        seq[0] += len(x)
        tr.run(max_windows=1, idle_timeout_s=30.0)
        return int(est.engine.step), fr.poll_now(), guard.last_score

    legs = [("clean",) + window(False) for _ in range(cfg["guard_clean"])]
    legs.append(("poisoned",) + window(True))
    for _ in range(cfg["guard_recover"]):
        legs.append(("clean",) + window(False))
        if legs[-1][2]:
            break
    snap = fr.snapshot()[0]
    fr.stop()
    est.shutdown()
    src.close()
    return {"legs": legs, "accepted": snap["guard_accepted"],
            "rejected": snap["guard_rejected"],
            "adopted_step": served.ckpt_stats().get("last_reload_step")}


def streaming_fleet_phase(card, root, srv, dev="cuda", cfg=STREAM):
    """A StreamingFleet of 2 NCF trainer processes over a 2-partition
    Redis stream keyed by user, with FleetReloaders adopting each
    partition's commits into a served copy. Consumer 0 is SIGKILLed after
    its first commit and respawned; each partition's final cursor must
    count exactly the records routed to it and end at its last id (none
    lost, none trained twice). Then the guard leg (``_guard_leg``).
    Returns the consumers' own flash-kernel launch counts."""
    from analytics_zoo_tpu_torch.models.recommendation.neuralcf import \
        NeuralCFNet
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.streaming import (FleetReloaders,
                                                   StreamingFleet, seq_id)
    parts, n_per = 2, cfg["fleet_window"] * cfg["fleet_windows"]
    pairs, labels, part = _fleet_keyed_records(n_per, parts, cfg["seed"])
    report_dir = os.path.join(root, "fleet-report")
    os.makedirs(report_dir, exist_ok=True)
    froot = os.path.join(root, "fleet")
    spec = f"redis://{srv.host}:{srv.port}/sfleet?claim_idle_ms=500"
    fleet = StreamingFleet(
        partial(_counted_stream_estimator, report_dir,
                partial(_stream_ncf_estimator, dev)), spec, froot,
        consumers=parts, batch_size=cfg["batch"],
        window_records=cfg["fleet_window"], window_age_s=600.0,
        poll_timeout_s=0.05,
        heartbeat_s=0.2, consumer_ttl_s=5.0, poll_s=0.1)
    fr = None
    try:
        router = spec + f"&partitions={parts}"
        half = len(pairs) // 2
        t0 = time.perf_counter()
        srv.produce(router, pairs, labels, 0, half, keyed=True).finish()
        fleet.start()
        if not fleet.wait_live(parts, timeout_s=120):
            fail(f"streaming_fleet: consumers never went live: "
                 f"{fleet.metrics()}")
        live_s = time.perf_counter() - t0
        models = {k: InferenceModel(device=dev).load_module(
            NeuralCFNet(**NCF_WIDTHS)) for k in range(parts)}
        fr = FleetReloaders(models, froot, poll_s=0.1, start_at=-1).start()
        _wait_for(lambda: _committed_cursor(fleet.partition_root(0))
                  is not None, 120, "consumer 0's first commit")
        if not fleet.kill_consumer(0):
            fail("streaming_fleet: consumer 0 was not alive to kill")
        srv.produce(router, pairs, labels, half, len(pairs), first_id=half,
                    keyed=True).finish()
        _wait_for(lambda: fleet.restarts >= 1, 120, "consumer 0's respawn")
        # the consumers run until stopped: done once every partition's
        # committed cursor holds all its records
        _wait_for(lambda: all(
            (_committed_cursor(fleet.partition_root(k)) or {}).get(
                "records", 0) >= n_per for k in range(parts)), 180,
            "every partition's records to commit")
        snap = fleet.stop()
        wall = time.perf_counter() - t0
        cursors = {k: _committed_cursor(fleet.partition_root(k))
                   for k in range(parts)}
        fr.poll_now()
        adopted = {k: fr.snapshot()[k].get("last_reload_step")
                   for k in range(parts)}
        fresh = fr.freshness_p99_by_consumer()
        fr.stop()
        fr = None
        guard = _guard_leg(dev, root, srv, cfg)
    finally:
        if fr is not None:
            fr.stop()
        if fleet.alive():
            fleet.stop()
    _, worker_launches = _worker_launches(report_dir)
    ids = [seq_id(i) for i in range(len(pairs))]
    want = {k: (int((part == k).sum()),
                [ids[i] for i in np.flatnonzero(part == k)][-1])
            for k in range(parts)}
    emit({"phase": "streaming_fleet", "nvidia_smi": card,
          "consumers": parts, "records": len(pairs),
          "records_per_partition": n_per, "spawn_to_live_s": live_s,
          "wall_s": wall, "restarts": snap["restarts"],
          "windows_total": snap["windows_total"],
          "cursors": cursors, "adopted_steps": adopted,
          "freshness_p99_by_consumer": fresh, "guard": guard,
          "consumer_launches": worker_launches})
    if snap["restarts"] != 1:
        fail(f"streaming_fleet: {snap['restarts']} restarts after one "
             f"SIGKILL")
    for k, (count, last) in want.items():
        cur = cursors[k] or {}
        if cur.get("records") != count or cur.get("last_id") != last:
            fail(f"streaming_fleet: partition {k} cursor {cur}, want "
                 f"{count} records ending at {last}")
    if any(adopted[k] is None for k in adopted):
        fail(f"streaming_fleet: adopted steps {adopted}")
    legs = guard["legs"]
    poisoned = [leg for leg in legs if leg[0] == "poisoned"]
    before = legs[:cfg["guard_clean"]]
    if not all(leg[2] for leg in before) or poisoned[0][2] or \
            not legs[-1][2] or legs[-1][0] != "clean" or \
            guard["adopted_step"] != legs[-1][1]:
        fail(f"streaming_fleet: guard leg {guard}: the clean commits must "
             f"be adopted, the poisoned one rejected, and a later clean "
             f"one adopted")
    return worker_launches


def _committed_cursor(root):
    from analytics_zoo_tpu_torch.ckpt import format as fmt
    dirs = fmt.loadable_step_dirs(root)
    return fmt.manifest_meta(dirs[-1][1]).get("stream") if dirs else None


def _fault_schedule(plan):
    """A fault registry firing at ``engine.dispatch`` by call number:
    ``plan`` maps a call to ``("delay", s)`` (a hang the watchdog must
    trip) or ``("raise",)`` (an injected device loss). A thread that hung
    is not counted again (a real hang never returns)."""
    from analytics_zoo_tpu_torch.resilience import faults

    class Schedule(faults.FaultRegistry):
        def __init__(self):
            super().__init__(seed=0)
            self.calls, self.hung = 0, []
            self.guard = threading.Lock()

        def fire(self, site):
            if site != "engine.dispatch":
                return
            me = threading.current_thread()
            with self.guard:
                if any(t is me for t in self.hung):
                    return
                self.calls += 1
                act = plan.get(self.calls)
                if act is not None and act[0] == "delay":
                    self.hung.append(me)
            if act is None:
                return
            if act[0] == "delay":
                time.sleep(act[1])
                return
            raise faults.InjectedFault(
                f"injected device loss at {site} (call {self.calls})")

    return faults.inject(registry=Schedule())


def supervised_fit_phase(card, root, dev="cuda", cfg=STREAM):
    """TrainingSupervisor over the online example's NCF estimator factory
    (NCF_WIDTHS, steps_per_dispatch 1), 4 epochs of 8 steps with
    ZOO_DISPATCH_TIMEOUT_S at ``sup_timeout_s``: epoch 2's fifth step
    stalls ``sup_stall_s`` in the dispatch (the watchdog trips: a hang),
    epoch 3's fifth step raises an injected device loss; each restarts
    from the last committed epoch. The report must read 2 restarts, 1
    hang, 1 crash, completed; the final weights are held against an
    unsupervised 4-epoch fit within TOL_SUPERVISED, whose 3-epoch weights
    (the control) must miss."""
    from analytics_zoo_tpu_torch.resilience import TrainingSupervisor
    pairs, ratings = _ncf_data(cfg["sup_rows"], seed=3)
    data = {"x": pairs, "y": ratings}
    steps = cfg["sup_rows"] // cfg["batch"]
    plan = {steps + steps // 2: ("delay", cfg["sup_stall_s"]),
            3 * steps: ("raise",)}
    d = os.path.join(root, "supervised")
    factory = partial(_stream_ncf_estimator, dev, d,
                      {"steps_per_dispatch": 1})
    old = os.environ.get("ZOO_DISPATCH_TIMEOUT_S")
    os.environ["ZOO_DISPATCH_TIMEOUT_S"] = str(cfg["sup_timeout_s"])
    try:
        sup = TrainingSupervisor(factory, max_restarts=3, poll_s=0.02)
        sup.retry_policy.base_delay_s = 0.05
        t0 = time.perf_counter()
        with _fault_schedule(plan):
            rep = sup.fit(data, epochs=cfg["sup_epochs"],
                          batch_size=cfg["batch"])
        wall = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("ZOO_DISPATCH_TIMEOUT_S", None)
        else:
            os.environ["ZOO_DISPATCH_TIMEOUT_S"] = old
    got = _est_params(sup.estimator)
    sup.estimator.shutdown()
    ref = partial(_stream_ncf_estimator, dev, None,
                  {"steps_per_dispatch": 1})()
    ref.fit(data, epochs=cfg["sup_epochs"] - 1, batch_size=cfg["batch"],
            verbose=False)
    short = _est_params(ref)
    ref.fit(data, epochs=1, batch_size=cfg["batch"], verbose=False,
            initial_epoch=cfg["sup_epochs"] - 1)
    want = _est_params(ref)
    rel_err, control = _max_param_rel(got, want), _max_param_rel(short, want)
    keys = ("restarts", "hangs", "crashes", "steps_replayed", "completed",
            "downtime_s")
    emit({"phase": "supervised_fit", "nvidia_smi": card,
          "widths": NCF_WIDTHS, "epochs": cfg["sup_epochs"],
          "steps_per_epoch": steps, "timeout_s": cfg["sup_timeout_s"],
          "stall_s": cfg["sup_stall_s"], "plan": {str(k): list(v)
                                                  for k, v in plan.items()},
          "report": {k: rep[k] for k in keys},
          "failures": [f["kind"] + ": " + f["error"]
                       for f in rep["failures"]],
          "wall_s": wall, "vs_unsupervised": rel_err, "control": control,
          "limit": TOL_SUPERVISED})
    if (rep["restarts"], rep["hangs"], rep["crashes"]) != (2, 1, 1) or \
            not rep["completed"]:
        fail(f"supervised_fit: report {[rep[k] for k in keys]}")
    if not rel_err <= TOL_SUPERVISED < control:
        fail(f"supervised_fit: vs unsupervised {rel_err}, control "
             f"{control}, limit {TOL_SUPERVISED}")


def streaming_paths(card):
    """The streaming slice's phases, each driven with the flash kernels'
    counts at 0 (a fleet path's count adds its consumers' own reports):
    none may launch a flash kernel (NCF and the linear model hold no
    attention). Returns the counts by path."""
    from analytics_zoo_tpu_torch.ops import attention as at
    kernels = [getattr(at, name) for name in FLASH_KERNELS]
    launches, data = {}, {}
    root = tempfile.mkdtemp(prefix="streaming-")
    # index_add_'s deterministic CUDA path (see STREAM): two runs of the
    # same windows then agree bit for bit
    determinism = (torch.are_deterministic_algorithms_enabled(),
                   torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    srv = _BrokerHost()
    try:
        for name, run in (
                ("streaming_ncf_online", lambda: data.update(
                    online=streaming_ncf_online_phase(card, root, srv))),
                ("streaming_fused_windows",
                 lambda: streaming_fused_windows_phase(card, root,
                                                       data["online"], srv)),
                ("streaming_resume",
                 lambda: streaming_resume_phase(card, root,
                                                data["online"], srv)),
                ("streaming_fleet",
                 lambda: streaming_fleet_phase(card, root, srv)),
                ("supervised_fit", lambda: supervised_fit_phase(card,
                                                                root))):
            for fn in kernels:
                fn.launches = 0
            elsewhere = run() or {}
            launches[name] = {
                fn.__name__: fn.launches + elsewhere.get(fn.__name__, 0)
                for fn in kernels}
            torch.cuda.empty_cache()
    finally:
        srv.stop()
        torch.use_deterministic_algorithms(determinism[0],
                                           warn_only=determinism[1])
        shutil.rmtree(root, ignore_errors=True)
    if any(n for counts in launches.values() for n in counts.values()):
        fail(f"a flash kernel launched on a streaming path: {launches}")
    return launches


# --- columnar paths: Friesian feature engineering and Parquet input ----------
# examples/friesian/recsys_feature_engineering.py at 1,000,000 click rows:
# the example's default is 60,000 rows and the reference runs Friesian on
# tens of millions; the cut is the smoke's time limit. Users are drawn
# from 33,000 and items from 8,300, which keeps the example's rows per
# user and per item (60,000 / 2,000 and / 500); the city and device lists
# are the example's. Its pipeline, then Wide & Deep at its widths (hidden
# 40/20/10, embeddings 16), 1 epoch at batch 512 with Adam on 90 % of the
# rows, held to its gate on the rest (accuracy >= majority baseline -
# 0.02). The session path takes 100,000 rows of the same log with a seeded
# time column into SessionRecommender at the JAX defaults (item_embed 100,
# GRUs 40/20, sessions of 5, history 10). The Parquet path writes 60,000
# seeded uint8 28x28x1 images (MNIST's shapes; each a class template plus
# noise, so a LeNet-5 can learn them) in blocks of 1,000 and fits them
# from read_as_xshards through TPUEstimator with a trace of the first
# epoch, 16 steps a dispatch: the epoch's 235 steps are then one eager
# group, a capture, 13 replays and 11 single steps, so the trace shows
# how replays appear (auto picked 128, and the epoch then held no
# replay). TOL_WND_VS_CPU: the largest difference of a parameter leaf
# relative to its largest entry after 2 Adam steps (lr 1e-3, batch 512)
# on the card and on the CPU from the same weights, f32; the control, the
# card after 3 steps, moves every parameter by about one more lr (the
# zero-initialised biases by half their value) and must miss.
FRIESIAN = dict(rows=1_000_000, users=33_000, items=8_300, batch=512,
                epochs=1, embed=16, hidden=(40, 20, 10), holdout=0.1,
                seed=0)
FRIESIAN_CITIES = ["nyc", "sf", "chi", "la", "sea", "bos", "atx", "den"]
FRIESIAN_DEVICES = ["ios", "android", "web"]
FRIESIAN_SESSION = dict(rows=100_000, users=33_000, items=8_300, max_len=10,
                        session=5, neg_num=1, batch=256, epochs=1, seed=1)
PARQUET_FIT = dict(rows=60_000, size=28, classes=10, block=1000, batch=256,
                   epochs=2, fuse=16, seed=2)
WND_VS_CPU = dict(rows=2048, batch=512, steps=2)
TOL_WND_VS_CPU = 1e-3


def click_log(n, users, items, seed=0, with_time=False):
    """The example's synthetic_click_log drawn with vectorised numpy:
    string users, items, cities and devices, prices with 5 % missing,
    exponential dwell times, a click label tied to the device and the
    price; ``with_time`` adds a seeded event time."""
    import pandas as pd
    rng = np.random.RandomState(seed)
    names = lambda prefix, k: np.array([f"{prefix}{i}" for i in range(k)])
    cols = {
        "user": names("u", users)[rng.randint(users, size=n)],
        "item": names("i", items)[rng.randint(items, size=n)],
        "city": np.array(FRIESIAN_CITIES)[
            rng.randint(len(FRIESIAN_CITIES), size=n)],
        "device": np.array(FRIESIAN_DEVICES)[
            rng.randint(len(FRIESIAN_DEVICES), size=n)],
        "price": np.where(rng.rand(n) < 0.05, np.nan,
                          np.exp(rng.randn(n) * 1.2 + 3)),
        "dwell_ms": rng.exponential(3000, n)}
    if with_time:
        cols["time"] = rng.permutation(n).astype(np.int64)
    df = pd.DataFrame(cols)
    click_p = (0.15 + 0.25 * (df["device"] == "ios")
               - 0.1 * (df["price"].fillna(df["price"].median()) > 40))
    df["label"] = (rng.rand(n) < click_p).astype(np.int32)
    return df


class _Stages:
    """Host seconds of each named stage."""

    def __init__(self):
        self.s = {}

    def __call__(self, name, fn):
        t = time.perf_counter()
        out = fn()
        self.s[name] = time.perf_counter() - t
        return out


def _frames_equal(got, want):
    from pandas.testing import assert_frame_equal
    try:
        assert_frame_equal(got, want, check_exact=True)
        return True
    except AssertionError:
        return False


def _wnd_features(df, sizes):
    """The example's W&D rows: device and the city x device cross one-hot
    (wide), city one-hot (indicator), user and item ids, price and dwell."""
    from analytics_zoo_tpu_torch.models import ColumnFeatureInfo
    user_n, item_n, city_n, dev_n = sizes
    n = len(df)
    dev_dim, city_dim = dev_n + 1, city_n + 1
    wide = np.zeros((n, dev_dim + 32), np.float32)
    wide[np.arange(n), df["device"]] = 1.0
    wide[np.arange(n), dev_dim + df["city_device"]] = 1.0
    indicator = np.zeros((n, city_dim), np.float32)
    indicator[np.arange(n), df["city"]] = 1.0
    ci = ColumnFeatureInfo(
        wide_base_cols=["device", "city_device"],
        wide_base_dims=[dev_dim, 32], indicator_cols=["city"],
        indicator_dims=[city_dim], embed_cols=["user", "item"],
        embed_in_dims=[user_n + 1, item_n + 1],
        embed_out_dims=[FRIESIAN["embed"]] * 2,
        continuous_cols=["price", "dwell_ms"])
    x = np.concatenate(
        [wide, indicator, df[["user", "item"]].to_numpy(np.float32),
         df[["price", "dwell_ms"]].to_numpy(np.float32)], axis=1)
    if x.shape[1] != ci.feature_width():
        fail(f"W&D rows are {x.shape[1]} wide, not {ci.feature_width()}")
    return x, df["label"].to_numpy(np.int32), ci


def _profiled_fit(dev, fit):
    """``fit()`` under torch.profiler on the card (``_fit_profile``: idle
    share, top kernels); on the CPU its wall time only."""
    if torch.device(dev).type == "cuda":
        return _fit_profile(fit)
    t0 = time.perf_counter()
    fit()
    return {"wall_ms": (time.perf_counter() - t0) * 1e3,
            "device_idle_share": "not measured"}


def _wnd_steps(dev, ci, state, x, y, steps):
    """``steps`` Adam steps of the example's Wide & Deep on ``dev`` from
    ``state`` (None: the model's own draw): start and end parameters."""
    from analytics_zoo_tpu_torch.models import WideAndDeep
    m = WideAndDeep(2, ci, "wide_n_deep", hidden_layers=FRIESIAN["hidden"],
                    device=dev)
    if state is not None:
        m.module.load_state_dict(state)
    m.compile(loss="sparse_categorical_crossentropy", optimizer="adam")
    start = {k: v.detach().cpu().clone()
             for k, v in m.module.state_dict().items()}
    m.fit({"x": x, "y": y}, epochs=1, batch_size=WND_VS_CPU["batch"],
          steps_per_epoch=steps, shuffle=False, verbose=False)
    return start, {k: v.detach().cpu().clone()
                   for k, v in m.module.state_dict().items()}


def friesian_wnd_phase(card, root, dev="cuda", cfg=FRIESIAN):
    """The example's Friesian pipeline on the click log, a Parquet round
    trip of the engineered table and of the user index, Wide & Deep fit
    and gated, and 2 steps against the CPU."""
    from analytics_zoo_tpu_torch.friesian.feature import (FeatureTable,
                                                          StringIndex)
    from analytics_zoo_tpu_torch.models import WideAndDeep
    st = _Stages()
    t0 = time.perf_counter()
    tbl = FeatureTable.from_pandas(st("generate", lambda: click_log(
        cfg["rows"], cfg["users"], cfg["items"], cfg["seed"])))
    user_idx, item_idx = st("gen_string_idx_user_item",
                            lambda: tbl.gen_string_idx(["user", "item"],
                                                       freq_limit=2))
    city_idx, dev_idx = st("gen_string_idx_city_device",
                           lambda: tbl.gen_string_idx(["city", "device"]))
    tbl = st("fill_median", lambda: tbl.fill_median(["price"]))
    tbl = st("clip", lambda: tbl.clip(["dwell_ms"], min=0, max=60_000))
    tbl = st("log", lambda: tbl.log(["price", "dwell_ms"]))
    tbl = st("normalize", lambda: tbl.normalize(["price", "dwell_ms"]))
    tbl = st("encode_string", lambda: tbl.encode_string(
        ["user", "item", "city", "device"],
        [user_idx, item_idx, city_idx, dev_idx]))
    tbl = st("cross_columns",
             lambda: tbl.cross_columns([["city", "device"]], [32]))
    path = os.path.join(root, "engineered.parquet")
    st("write_parquet", lambda: tbl.write_parquet(path))
    back = st("read_parquet", lambda: FeatureTable.read_parquet(path))
    ipath = os.path.join(root, "user_index.parquet")
    st("string_index_write", lambda: user_idx.write_parquet(ipath))
    iback = st("string_index_read", lambda: StringIndex.read_parquet(ipath))
    round_trips = {"table": _frames_equal(back.df, tbl.df),
                   "user_index": _frames_equal(iback.df, user_idx.df)
                   and iback.col_name == user_idx.col_name}
    sizes = [i.size() for i in (user_idx, item_idx, city_idx, dev_idx)]
    x, y, ci = st("assemble", lambda: _wnd_features(tbl.to_pandas(), sizes))
    host_s = time.perf_counter() - t0
    split = int((1 - cfg["holdout"]) * len(x))
    wnd = WideAndDeep(2, ci, "wide_n_deep", hidden_layers=cfg["hidden"],
                      device=dev)
    wnd.compile(loss="sparse_categorical_crossentropy", optimizer="adam")
    t = time.perf_counter()
    stats = wnd.fit({"x": x[:split], "y": y[:split]}, epochs=cfg["epochs"],
                    batch_size=cfg["batch"], profile=True, verbose=False)
    _sync(dev)
    fit_s = time.perf_counter() - t
    steady, step_ms = _steady_rate(stats, cfg["batch"])
    probs = np.asarray(wnd.predict(x[split:], batch_size=8192))
    acc = float((np.argmax(probs, -1) == y[split:]).mean())
    base = float(max(y[split:].mean(), 1 - y[split:].mean()))
    fuse = wnd.estimator.fuse
    # the device's idle share over a profiled fit of the first
    # 256 batches (the full fit's graphs replayed): torch.profiler's
    # processing of the whole fit's records took longer than the fit
    prof = _profiled_fit(dev, lambda: wnd.fit(
        {"x": x[:256 * cfg["batch"]], "y": y[:256 * cfg["batch"]]},
        epochs=1, batch_size=cfg["batch"], verbose=False))
    del wnd
    # 2 steps on the card against the CPU from the same weights
    vx, vy = x[:WND_VS_CPU["rows"]], y[:WND_VS_CPU["rows"]]
    start, cpu = _wnd_steps("cpu", ci, None, vx, vy, WND_VS_CPU["steps"])
    _, card_p = _wnd_steps(dev, ci, start, vx, vy, WND_VS_CPU["steps"])
    _, ctl_p = _wnd_steps(dev, ci, start, vx, vy, WND_VS_CPU["steps"] + 1)
    vs_cpu, ctl = _param_rel(card_p, cpu), _param_rel(ctl_p, cpu)
    out = {"phase": "friesian_wnd", "nvidia_smi": card, "rows": len(x),
           "train_rows": split, "vocab": dict(zip(
               ("user", "item", "city", "device"), sizes)),
           "feature_width": ci.feature_width(), "host_stage_s": st.s,
           "host_s": host_s, "round_trips_equal": round_trips,
           "fit_s": fit_s, "fit_samples_per_s": split * cfg["epochs"] / fit_s,
           "steady_samples_per_s": steady, "steady_step_ms": step_ms,
           "steps": sum(len(s["profile"]["step_ms"]) for s in stats),
           "fuse": fuse, "train_loss": stats[-1]["train_loss"],
           "device_idle_share": prof["device_idle_share"],
           "top_kernels": prof.get("top_kernels", [])[:3],
           "holdout_accuracy": acc, "majority_baseline": base,
           "vs_cpu_param_rel": vs_cpu, "vs_cpu_control": ctl,
           "limit": TOL_WND_VS_CPU, "run_s": time.perf_counter() - t0}
    emit(out)
    if not (all(round_trips.values()) and acc >= base - 0.02
            and math.isfinite(stats[-1]["train_loss"])
            and vs_cpu <= TOL_WND_VS_CPU < ctl):
        fail(f"friesian_wnd: {out}")


def friesian_session_phase(card, dev="cuda", cfg=FRIESIAN_SESSION):
    """The session features of 100,000 log rows (negative samples, item
    histories, negative histories, mask and pad, lengths) into
    SessionRecommender at the JAX defaults with history, fit 1 epoch on
    the positive rows: the session is the last 5 items of the history, the
    label the row's item."""
    from analytics_zoo_tpu_torch.friesian.feature import FeatureTable
    from analytics_zoo_tpu_torch.models import SessionRecommender
    st = _Stages()
    t0 = time.perf_counter()
    log = st("generate", lambda: click_log(cfg["rows"], cfg["users"],
                                           cfg["items"], cfg["seed"],
                                           with_time=True))
    tbl = FeatureTable.from_pandas(log[["user", "item", "time"]])
    user_idx, item_idx = st("gen_string_idx",
                            lambda: tbl.gen_string_idx(["user", "item"]))
    tbl = st("encode_string", lambda: tbl.encode_string(
        ["user", "item"], [user_idx, item_idx]))
    n_items = item_idx.size()
    tbl = st("add_negative_samples", lambda: tbl.add_negative_samples(
        n_items + 1, neg_num=cfg["neg_num"]))
    tbl = st("add_hist_seq", lambda: tbl.add_hist_seq(
        "user", ["item"], max_len=cfg["max_len"]))
    tbl = st("add_neg_hist_seq", lambda: tbl.add_neg_hist_seq(
        n_items + 1, "item_hist_seq", cfg["neg_num"]))
    tbl = st("add_length", lambda: tbl.add_length("item_hist_seq"))
    tbl = st("mask_pad", lambda: tbl.mask_pad(
        ["item_hist_seq", "neg_item_hist_seq"], ["item_hist_seq"],
        seq_len=cfg["max_len"]))
    df = tbl.to_pandas()
    pos = (df["label"] == 1).to_numpy()
    hist = np.array(df["item_hist_seq"].tolist(), np.int32)[pos]
    lens = np.minimum(df["item_hist_seq_length"].to_numpy()[pos],
                      cfg["max_len"])
    # the session: the last ``session`` items of the history, 0 before it
    last = lens[:, None] - cfg["session"] + np.arange(cfg["session"])
    session = np.where(last >= 0, np.take_along_axis(
        hist, np.clip(last, 0, None), 1), 0)
    x = np.concatenate([session, hist], 1).astype(np.int32)
    y = df["item"].to_numpy(np.int32)[pos]
    mask = np.array(df["item_hist_seq_mask"].tolist(), np.int32)[pos]
    if not (mask.sum(1) == lens).all():
        fail("friesian_session: the history mask disagrees with its length")
    host_s = time.perf_counter() - t0
    sr = SessionRecommender(n_items, item_embed=100,
                            rnn_hidden_layers=(40, 20),
                            session_length=cfg["session"],
                            include_history=True,
                            history_length=cfg["max_len"], device=dev)
    sr.compile(loss="sparse_categorical_crossentropy", optimizer="adam")
    t = time.perf_counter()
    stats = sr.fit({"x": x, "y": y}, epochs=cfg["epochs"],
                   batch_size=cfg["batch"], profile=True, verbose=False)
    _sync(dev)
    fit_s = time.perf_counter() - t
    steady, step_ms = _steady_rate(stats, cfg["batch"])
    recs = sr.recommend_for_session(x[:64], max_items=5)
    out = {"phase": "friesian_session", "nvidia_smi": card,
           "log_rows": cfg["rows"], "rows_after_negatives": len(df),
           "train_rows": len(x), "items": n_items,
           "host_stage_s": st.s, "add_hist_seq_s": st.s["add_hist_seq"],
           "host_s": host_s, "fit_s": fit_s,
           "fit_samples_per_s": len(x) * cfg["epochs"] / fit_s,
           "steady_samples_per_s": steady, "steady_step_ms": step_ms,
           "train_loss": stats[-1]["train_loss"],
           "run_s": time.perf_counter() - t0}
    emit(out)
    if not (math.isfinite(stats[-1]["train_loss"]) and len(recs) == 64
            and all(len(r) == 5 for r in recs)):
        fail(f"friesian_session: {out}")


class LeNet5(torch.nn.Module):
    """LeNet-5 as a user writes it in torch, over uint8 NHWC digits."""

    def __init__(self, classes=10):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(1, 6, 5, padding=2)
        self.conv2 = torch.nn.Conv2d(6, 16, 5)
        self.fc1 = torch.nn.Linear(16 * 5 * 5, 120)
        self.fc2 = torch.nn.Linear(120, 84)
        self.fc3 = torch.nn.Linear(84, classes)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).float() / 255.0
        x = torch.nn.functional.max_pool2d(torch.relu(self.conv1(x)), 2)
        x = torch.nn.functional.max_pool2d(torch.relu(self.conv2(x)), 2)
        x = torch.relu(self.fc1(x.flatten(1)))
        return self.fc3(torch.relu(self.fc2(x)))


def _digits(cfg):
    """Seeded class templates plus noise, uint8 (n, size, size, 1)."""
    rng = np.random.RandomState(cfg["seed"])
    s = cfg["size"]
    templates = rng.randint(0, 256, (cfg["classes"], s, s, 1))
    labels = rng.randint(0, cfg["classes"], cfg["rows"])
    noise = rng.randint(0, 256, (cfg["rows"], s, s, 1))
    return ((templates[labels] + noise) // 2).astype(np.uint8), labels


def _trace_kernels(trace_dir):
    """Kernel time by name from the one chrome trace in ``trace_dir``, and
    the host's cudaGraphLaunch calls in it."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    if len(files) != 1:
        fail(f"parquet_fit: {len(files)} traces in {trace_dir}: {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    launches = {e.get("args", {}).get("correlation") for e in events
                if e.get("name") == "cudaGraphLaunch"}
    by_kernel = collections.defaultdict(float)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    for e in kernels:
        by_kernel[e["name"]] += e.get("dur", 0) / 1e3
    return {"events": len(events), "by_kernel": by_kernel,
            "kernel_records": len(kernels),
            # a replayed kernel's record carries its cudaGraphLaunch's
            # correlation id
            "kernel_records_of_graph_launches": sum(
                1 for e in kernels
                if e.get("args", {}).get("correlation") in launches),
            "graph_launches": len(launches - {None}),
            "optimizer_step_ranges": sum(
                1 for e in events if e.get("cat") == "user_annotation"
                and e["name"].startswith("Optimizer.step#"))}


def parquet_fit_phase(card, root, dev="cuda", cfg=PARQUET_FIT):
    """MNIST-shaped digits through write_ndarrays, read_as_xshards and a
    LeNet-5 fit with ``feature_cols``/``label_cols`` and ``profile=<dir>``
    (the trace must name the step's kernels); read_as_torch against
    read_as_xshards; a TextSet parquet table read back."""
    import pandas as pd
    from analytics_zoo_tpu_torch.feature.text import TextSet
    from analytics_zoo_tpu_torch.orca.data.image import (ParquetDataset,
                                                         write_ndarrays)
    from analytics_zoo_tpu_torch.orca.learn import losses
    from analytics_zoo_tpu_torch.orca.learn.estimator import TPUEstimator
    st = _Stages()
    t0 = time.perf_counter()
    images, labels = st("generate", lambda: _digits(cfg))
    path = os.path.join(root, "digits")
    st("write_ndarrays", lambda: write_ndarrays(
        images, labels, path, block_size=cfg["block"]))
    shards = st("read_as_xshards",
                lambda: ParquetDataset.read_as_xshards(path))
    parts = shards.collect()
    got_images = np.concatenate([p["image"] for p in parts])
    got_labels = np.concatenate([p["label"] for p in parts])
    if not (np.array_equal(got_images, images)
            and np.array_equal(got_labels, labels)):
        fail("parquet_fit: read_as_xshards does not give the written rows")
    ds = st("read_as_torch", lambda: ParquetDataset.read_as_torch(path))
    torch_rows = len(ds) == len(images) and all(
        np.array_equal(ds[i]["image"], got_images[i])
        and ds[i]["label"] == got_labels[i]
        for i in (0, 1, len(ds) // 2, len(ds) - 1))
    torch.manual_seed(cfg["seed"])
    est = TPUEstimator(LeNet5(cfg["classes"]), loss=partial(
        losses.sparse_categorical_crossentropy, from_logits=True),
        optimizer="adam", device=dev,
        config={"steps_per_dispatch": cfg["fuse"]})
    trace_dir = os.path.join(root, "trace")
    t = time.perf_counter()
    stats = est.fit(shards, epochs=cfg["epochs"], batch_size=cfg["batch"],
                    feature_cols=["image"], label_cols=["label"],
                    profile=trace_dir, verbose=False)
    _sync(dev)
    fit_s = time.perf_counter() - t
    steady, step_ms = _steady_rate(stats, cfg["batch"])
    trace = _trace_kernels(trace_dir)
    by_kernel = trace.pop("by_kernel")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:3]
    texts = ["héllo wörld", "", "a, b; c.", "line\nbreak", "x" * 300]
    tpath = os.path.join(root, "texts.parquet")
    pd.DataFrame({"uri": [f"doc/{i}" for i in range(len(texts))],
                  "text": texts}).to_parquet(tpath)
    tset = TextSet.read_parquet(tpath)
    text_ok = (tset.get_texts() == texts
               and tset.get_uris() == [f"doc/{i}" for i in range(5)])
    losses_ = [s["train_loss"] for s in stats]
    out = {"phase": "parquet_fit", "nvidia_smi": card, "rows": len(images),
           "blocks": len(parts), "host_stage_s": st.s, "fit_s": fit_s,
           "epoch_losses": losses_, "steady_samples_per_s": steady,
           "steady_step_ms": step_ms,
           "trace": {**trace, "kernel_names": len(by_kernel),
                     "top_kernels": [{"name": n[:120], "ms": ms}
                                     for n, ms in top]},
           "epoch0_steps": len(stats[0]["profile"]["step_ms"]),
           "fuse": est.fuse,
           "read_as_torch_rows_equal": torch_rows,
           "textset_parquet_equal": text_ok,
           "run_s": time.perf_counter() - t0}
    emit(out)
    kernels_seen = bool(by_kernel) or torch.device(dev).type != "cuda"
    if not (kernels_seen and torch_rows and text_ok
            and all(math.isfinite(v) for v in losses_)
            and losses_[-1] < losses_[0]):
        fail(f"parquet_fit: {out}")


def columnar_paths(card, dev="cuda"):
    """The Friesian and Parquet slice's phases, each driven with the flash
    kernels' counts at 0: none may launch one (W&D, SessionRecommender and
    LeNet-5 hold no attention). Returns the counts by path."""
    import importlib.util
    from analytics_zoo_tpu_torch.ops import attention as at
    specs = {m: importlib.util.find_spec(m) is not None
             for m in ("pandas", "pyarrow.parquet")}
    emit({"phase": "columnar_modules", "find_spec": specs})
    if not all(specs.values()):
        fail(f"columnar_paths needs pandas and pyarrow: {specs}")
    kernels = [getattr(at, name) for name in FLASH_KERNELS]
    launches = {}
    root = tempfile.mkdtemp(prefix="columnar-")
    t0 = time.perf_counter()
    try:
        for name, run in (
                ("friesian_wnd",
                 lambda: friesian_wnd_phase(card, root, dev)),
                ("friesian_session",
                 lambda: friesian_session_phase(card, dev)),
                ("parquet_fit", lambda: parquet_fit_phase(card, root, dev))):
            for fn in kernels:
                fn.launches = 0
            run()
            launches[name] = {fn.__name__: fn.launches for fn in kernels}
            if torch.device(dev).type == "cuda":
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "columnar_paths", "group_s": time.perf_counter() - t0,
          "launches": launches})
    if any(n for counts in launches.values() for n in counts.values()):
        fail(f"a flash kernel launched on a columnar path: {launches}")
    return launches


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
    fleet_launches = serving_tier_paths(card)
    fused_launches = fused_dispatch_phase(card)
    tcmf_fs_launches = tcmf_featureset_paths(card)
    text_launches = text_zoo_paths(card)
    image_launches = image_paths(card)
    tfpark_launches = tfpark_paths(card)
    kernels_line(errs, bwd_errs, serve_launches, train_launches,
                 fraud_launches, autots_launches, od_launches,
                 {**slice_launches, **fleet_launches, **fused_launches,
                  **tcmf_fs_launches, **text_launches, **image_launches,
                  **tfpark_launches},
                 late_paths=lambda: {**streaming_paths(card),
                                     **columnar_paths(card)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
