"""Training loop: epochs, schedule, validation, results and checkpoints
(counterpart of ``tpu_captioner/train/loop.py``; reference train.py:95-236).

- at epoch ``fine_tune_epoch`` (20) the encoder children from
  ``starting_layer`` on start to train, with a FRESH encoder Adam
  (train.py:161-165);
- early stop after ``early_stop_patience`` epochs without a better BLEU-4;
  both learning rates times 0.8 whenever that count is a positive multiple
  of ``lr_decay_every`` (train.py:168-174);
- per epoch a row {epoch, trainLoss, trainTop5Acc, trainBatchTime,
  trainDataTime, valLoss, valTop5Acc, bleu1..4}, the results CSV at the end
  (train.py:201-236), written with the ``csv`` module;
- a checkpoint every epoch, with a ``BEST_`` copy when BLEU-4 improves;
- validation decodes greedily (``max_decode_len`` 51) and scores corpus
  BLEU-1..4 against references without ``<start>``/``<pad>``, hypotheses
  cut after the first ``<end>`` (train.py:414-437), with the native scorer
  (``native/bleu_native.py``, equal to ``eval/bleu.py``);
- with ``profile_dir`` set, steps 2-6 of the first epoch this Trainer runs
  are traced with ``torch.profiler`` (host activity, and the card's when it
  runs there) into one Chrome-trace file that TensorBoard and Perfetto open,
  as the JAX Trainer traces them with ``jax.profiler``.

Loss and top-5 are token-weighted.  Each step's metrics stay on the device
and are folded on the host every ``FOLD_EVERY`` steps and at the epoch's
end, so a step adds no synchronise of its own; ``batch_time`` and
``data_time`` are host-clock times, as the JAX package's (the device runs
behind the host).

Data parallel (``mesh``, a ``parallel.mesh.Mesh`` of N ranks, one process
each; counterpart of the JAX Trainer over its ``'data'`` mesh): the global
batch is ``batch_size * N``, each rank loads and steps on its rows, and
loss and top-5 are global.  Validation gathers each batch's fixed-shape
outputs to every rank, and rank 0 alone builds the corpora and scores BLEU,
then broadcasts the four scores, so the early stop, the LR decay and the
unlock, decided from them, stay in lock step.  Rank 0 alone writes the
results CSV, the checkpoints (the other ranks wait at a barrier) and the
trace, and prints; ``batch_time`` and ``data_time`` are each rank's own,
and rank 0's are the ones reported.  The native host library is built when
the Trainer is, not inside the first batch's ``data_time``.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_captioner_torch.core import prng
from tpu_captioner_torch.core.config import LSTM_DECODERS, ExperimentConfig
from tpu_captioner_torch.data.dataset import CaptionDataset
from tpu_captioner_torch.data.loader import DeviceLoader
from tpu_captioner_torch.data.vocab import load_word_map, special_ids
from tpu_captioner_torch.eval.metrics import AverageMeter
from tpu_captioner_torch.native.bleu_native import bleu_1_to_4
from tpu_captioner_torch.native.lib import get_lib
from tpu_captioner_torch.parallel.collectives import barrier, broadcast_scalar, gather_eval_outputs, is_coordinator
from tpu_captioner_torch.parallel.mesh import Mesh, make_mesh
from tpu_captioner_torch.train.checkpoint import checkpoint_name, restore_checkpoint, save_checkpoint
from tpu_captioner_torch.train.model import CaptionModel
from tpu_captioner_torch.train.state import TrainState, broadcast_parameters, scale_lr
from tpu_captioner_torch.train.steps import make_eval_step, make_train_step

FOLD_EVERY = 1024  # steps whose metrics wait on the device before a fold
TRACE_STEPS = (2, 6)  # the first epoch's steps traced with profile_dir, both included (after the warm-up)
RESULT_KEYS = ("epoch", "trainLoss", "trainTop5Acc", "trainBatchTime", "trainDataTime", "valLoss",
               "valTop5Acc", "bleu1", "bleu2", "bleu3", "bleu4")


def build_references_and_hypotheses(
    all_captions: np.ndarray,  # (B, cpi, L)
    sequences: np.ndarray,  # (B, T)
    lengths: np.ndarray,  # (B,)
    valid: np.ndarray,  # (B,)
    start_id: int,
    pad_id: int,
) -> Tuple[List[List[List[int]]], List[List[int]]]:
    """The BLEU corpora of a batch's valid rows (train.py:414-429):
    references without ``<start>``/``<pad>`` (``<end>`` and ``<unk>``
    kept), hypotheses cut at the decode length (the first ``<end>``
    included)."""
    references, hypotheses = [], []
    for j in range(all_captions.shape[0]):
        if not valid[j]:
            continue
        references.append([[int(w) for w in cap if w != start_id and w != pad_id] for cap in all_captions[j]])
        hypotheses.append([int(w) for w in sequences[j, : lengths[j]]])
    return references, hypotheses


class _TokenSums:
    """Token-weighted loss and top-5 over steps whose (loss, tokens,
    top5_correct) stay on the device until ``fold``."""

    def __init__(self):
        self.pending: List[torch.Tensor] = []
        self.sums = np.zeros(3)  # sum of loss x tokens, top5, tokens

    def add(self, metrics: Dict[str, torch.Tensor]) -> None:
        self.pending.append(torch.stack([metrics[k].float() for k in ("loss", "tokens", "top5_correct")]))
        if len(self.pending) >= FOLD_EVERY:
            self.fold()

    def fold(self) -> None:
        if self.pending:
            rows = torch.stack(self.pending).cpu().double().numpy()
            self.pending.clear()
            self.sums += [(rows[:, 0] * rows[:, 1]).sum(), rows[:, 2].sum(), rows[:, 1].sum()]

    def means(self) -> Tuple[float, float]:
        """(loss per token, top-5 percent)."""
        self.fold()
        tokens = max(self.sums[2], 1.0)
        return float(self.sums[0] / tokens), float(100.0 * self.sums[1] / tokens)


def _load_torch_state_dict(path: str) -> Dict[str, Any]:
    """``torch.load`` and unwrap: a pickled module gives its state dict, a
    dict under ``state_dict`` or ``model`` gives that dict."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    for wrapper in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(wrapper), dict):
            obj = obj[wrapper]
    return dict(obj)


def convert_backbone_to_npz(src: str, out: str) -> None:
    """A torchvision ``convnext_base`` checkpoint as an ``.npz`` of its
    unwrapped state dict's arrays (``build_data port-backbone``; the JAX
    package's ``models/port_torch.py:convert_backbone_to_npz``).  The
    Trainer's ``pretrained_encoder`` takes either file."""
    sd = _load_torch_state_dict(src)
    np.savez(out, **{k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                     for k, v in sd.items()})


@dataclasses.dataclass
class Trainer:
    exp: ExperimentConfig
    data_folder: str
    data_name: str
    device: Any = "cuda"
    verbose: bool = True
    # A directory for a torch.profiler trace of steps TRACE_STEPS of the
    # first epoch this Trainer runs (the JAX Trainer's profile_dir).
    profile_dir: Optional[str] = None
    # This rank's place among the data-parallel ranks (None: the initialised
    # process group's, else a world of one).
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        exp, tc = self.exp, self.exp.train
        if self.mesh is None:
            self.mesh = make_mesh(exp.num_devices, self.device)
        elif exp.num_devices not in (0, self.mesh.size):
            raise ValueError(f"{exp.num_devices} devices asked for on a mesh of {self.mesh.size} ranks")
        self.device = self.mesh.device
        self.coordinator = is_coordinator(self.mesh)
        self.verbose = self.verbose and self.coordinator
        get_lib()  # the native BLEU and gather: built now, not in the first batch
        self.word_map = load_word_map(os.path.join(self.data_folder, f"WORDMAP_{self.data_name}.json"))
        self.word_ids = special_ids(self.word_map)
        exp.model.vocab_size = len(self.word_map)
        pretrained = None
        if exp.model.embedding_path and os.path.exists(exp.model.embedding_path):
            from tpu_captioner_torch.models.embeddings import load_pretrained_word_embeddings

            pretrained = load_pretrained_word_embeddings(
                self.word_map, exp.model.embedding_path, exp.model.embed_dim
            )
        self.model = CaptionModel(exp.model, device=self.device, seed=tc.seed, pretrained_embeddings=pretrained)
        if exp.model.pretrained_encoder:
            self._load_backbone(exp.model.pretrained_encoder)
        self.state = TrainState.create(self.model, tc, self.mesh)

        # Host bookkeeping (reference globals, train.py:47-57).
        self.start_epoch = 0
        self.best_bleu4 = 0.0
        self.epochs_since_improvement = 0
        self.results: List[Dict[str, Any]] = []
        self.fine_tune_encoder = tc.fine_tune_encoder
        self._root = prng.root_seed(tc.seed)
        self._steps: Dict[Any, Any] = {}
        if tc.checkpoint:
            self.state, meta = restore_checkpoint(tc.checkpoint, self.state)
            broadcast_parameters(self.model, self.mesh)
            self.start_epoch = meta["epoch"] + 1
            self.epochs_since_improvement = meta["epochs_since_improvement"]
            self.best_bleu4 = meta["bleu4"]
            self.results = meta.get("results", [])
            self.fine_tune_encoder = self.start_epoch > tc.fine_tune_epoch  # train.py:128-134

        kw = dict(seed=tc.seed, mesh=self.mesh)
        self.train_loader = DeviceLoader(
            CaptionDataset(self.data_folder, self.data_name, "TRAIN"), tc.batch_size, shuffle=True, **kw
        )
        self.val_loader = DeviceLoader(
            CaptionDataset(self.data_folder, self.data_name, "VAL"), tc.batch_size, shuffle=False, **kw
        )

    def _load_backbone(self, path: str) -> None:
        """Pretrained ConvNeXt weights (reference models/encoder.py:18) from a
        torchvision ``convnext_base`` state dict, or the ``.npz`` of its
        arrays that ``build_data port-backbone`` writes, checked against the
        configured backbone so a wrong-size file fails at start-up."""
        if path.endswith(".npz"):
            with np.load(path) as arrays:
                sd = {k: torch.from_numpy(arrays[k]) for k in arrays.files}
        else:
            sd = _load_torch_state_dict(path)
        if any(k.startswith("features.") for k in sd):
            sd = {k[len("features."):]: v for k, v in sd.items() if k.startswith("features.")}
        loaded = {f"convnext.{k}": v for k, v in sd.items()}
        want = self.model.encoder.state_dict()
        problems = []
        for name, a in want.items():
            b = loaded.get(name)
            if b is None:
                problems.append(f"missing {name}")
            elif tuple(a.shape) != tuple(b.shape):
                problems.append(f"{name}: shape {tuple(b.shape)} != {tuple(a.shape)}")
        if problems or len(loaded) != len(want):
            raise ValueError(
                f"pretrained encoder {path!r} does not match the configured backbone "
                f"(depths={tuple(self.exp.model.encoder_depths)}; {len(loaded)} vs {len(want)} tensors): "
                + "; ".join(problems[:5])
            )
        self.model.encoder.load_state_dict(loaded)
        if self.verbose:
            print(f"Initialized encoder backbone from {path}", flush=True)

    # -- steps --------------------------------------------------------------
    def _train_step(self):
        key = (self.exp.train.teacher_forcing, self.fine_tune_encoder)
        if key not in self._steps:
            self._steps[key] = make_train_step(
                self.model, self.exp.train, self.word_ids, teacher_forcing=key[0], train_encoder=key[1],
                mesh=self.mesh,
            )
        return self._steps[key]

    def _eval_step(self):
        if "eval" not in self._steps:
            self._steps["eval"] = make_eval_step(self.model, self.exp.train, self.word_ids, mesh=self.mesh)
        return self._steps["eval"]

    # -- epochs -------------------------------------------------------------
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        tc = self.exp.train
        step_fn = self._train_step()
        batch_time, data_time = AverageMeter(), AverageMeter()
        sums = _TokenSums()
        n_batches = len(self.train_loader)
        trace = None
        start = time.time()
        for i, batch in enumerate(self.train_loader.epoch(epoch)):
            data_time.update(time.time() - start)
            if (self.profile_dir is not None and self.coordinator and epoch == self.start_epoch
                    and TRACE_STEPS[0] <= i <= TRACE_STEPS[1]):
                trace = self._trace_step(trace, i)
            self.state, metrics = step_fn(self.state, batch, prng.step_seed(self._root, "dropout", epoch, i))
            if trace is not None and i == TRACE_STEPS[1]:
                self._end_trace(trace, epoch, i)
                trace = None
            sums.add(metrics)
            batch_time.update(time.time() - start)
            start = time.time()
            if self.verbose and i % tc.print_freq == 0:
                print(f"{'TF' if tc.teacher_forcing else 'No TF'}, Epoch {epoch}, Batch {i + 1}/{n_batches}",
                      flush=True)
        if trace is not None:  # an epoch shorter than the window
            self._end_trace(trace, epoch, i)
        loss, top5 = sums.means()
        out = {"loss": loss, "top5": top5, "batch_time": batch_time.avg, "data_time": data_time.avg}
        if self.verbose:
            print(f"Epoch {epoch}: Training Loss = {loss:.4f}, Top-5 Accuracy = {top5:.4f}", flush=True)
        return out

    def _trace_step(self, trace, i: int):
        """Start the trace at the window's first step, then mark step ``i``
        (a ``ProfilerStep#i`` span on the host's timeline)."""
        from torch.profiler import ProfilerAction, ProfilerActivity, profile

        if trace is None:
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize(self.device)  # the window holds the traced steps' work alone
            # A schedule that records every step: the profiler then marks them.
            trace = profile(activities=activities, schedule=lambda step: ProfilerAction.RECORD)
            trace.step_num = i
            trace.start()
        else:
            trace.step()
        return trace

    def _end_trace(self, trace, epoch: int, last: int) -> None:
        """Wait for the traced steps' work, stop the trace and write it as
        ``profile_dir/trace_epoch<e>_steps<a>-<b>.pt.trace.json``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        trace.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"trace_epoch{epoch}_steps{TRACE_STEPS[0]}-{last}.pt.trace.json")
        trace.export_chrome_trace(path)
        if self.verbose:
            print(f"Wrote the trace of steps {TRACE_STEPS[0]}-{last} of epoch {epoch} to {path}", flush=True)

    def evaluate(self, loader: DeviceLoader, epoch: int = 0) -> Dict[str, float]:
        """Greedy free-running evaluation with BLEU (train.py:367-441
        validate, test.py:144-215 test); under a mesh, ``loader`` holds
        this rank's rows and BLEU is rank 0's score of every rank's,
        broadcast."""
        eval_step = self._eval_step()
        sums = _TokenSums()
        references, hypotheses = [], []
        sid, pid = self.word_ids["<start>"], self.word_ids["<pad>"]
        for batch in loader.epoch(epoch):
            aux = eval_step(batch)
            gathered = gather_eval_outputs(
                aux["sequences"].cpu().numpy(), aux["lengths"].cpu().numpy(),
                batch["all_captions"].cpu().numpy(), batch["valid"].cpu().numpy(), self.mesh,
            )
            if self.coordinator:
                seqs, lengths, all_caps, valid = gathered
                refs, hyps = build_references_and_hypotheses(all_caps, seqs, lengths, valid, sid, pid)
                references.extend(refs)
                hypotheses.extend(hyps)
            sums.add(aux)
        loss, top5 = sums.means()
        scores = bleu_1_to_4(references, hypotheses) if self.coordinator else (0.0,) * 4
        # The early stop, LR decay and unlock follow BLEU-4: every rank the same (trainMultiGPU.py:325).
        b1, b2, b3, b4 = (broadcast_scalar(b, self.mesh) for b in scores)
        out = {"loss": loss, "top5": top5, "bleu1": b1, "bleu2": b2, "bleu3": b3, "bleu4": b4}
        if self.verbose:
            print(f"Eval: Loss = {loss:.4f}, Top-5 = {top5:.4f}, B1 = {b1:.4f}, B2 = {b2:.4f}, "
                  f"B3 = {b3:.4f}, B4 = {b4:.4f}", flush=True)
        return out

    # -- the run ------------------------------------------------------------
    def checkpoint_name(self) -> str:
        tc, mc = self.exp.train, self.exp.model
        return checkpoint_name(self.data_name, mc.decoder in LSTM_DECODERS, tc.starting_layer, tc.encoder_lr,
                               mc.embedding_name)

    def run(self) -> List[Dict[str, Any]]:
        tc = self.exp.train
        for epoch in range(self.start_epoch, tc.epochs):
            if epoch == tc.fine_tune_epoch and not self.fine_tune_encoder:
                self.fine_tune_encoder = True
                self.state.reinit_encoder_optimizer(tc.encoder_lr)
                if self.verbose:
                    print(f"Fine-tuning encoder from epoch {epoch} onwards "
                          f"(starting from layer {tc.starting_layer})", flush=True)
            if self.epochs_since_improvement == tc.early_stop_patience:
                break
            if self.epochs_since_improvement > 0 and self.epochs_since_improvement % tc.lr_decay_every == 0:
                scale_lr(self.state.dec_opt, tc.lr_decay_factor)
                if self.fine_tune_encoder:
                    scale_lr(self.state.enc_opt, tc.lr_decay_factor)

            tr = self.train_epoch(epoch)
            val = self.evaluate(self.val_loader, epoch)
            self.results.append(dict(zip(RESULT_KEYS, (
                epoch, tr["loss"], tr["top5"], tr["batch_time"], tr["data_time"], val["loss"], val["top5"],
                val["bleu1"], val["bleu2"], val["bleu3"], val["bleu4"],
            ))))
            is_best = val["bleu4"] > self.best_bleu4
            self.best_bleu4 = max(val["bleu4"], self.best_bleu4)
            if is_best:
                self.epochs_since_improvement = 0
            else:
                self.epochs_since_improvement += 1
                if self.verbose:
                    print(f"\nEpochs since last improvement: {self.epochs_since_improvement}\n", flush=True)
            if self.coordinator:  # the other ranks wait at the barrier
                save_checkpoint(
                    tc.checkpoint_dir, self.checkpoint_name(), self.state,
                    {
                        "epoch": epoch,
                        "epochs_since_improvement": self.epochs_since_improvement,
                        "bleu4": val["bleu4"],
                        "results": self.results,
                        # Self-describing: a consumer rebuilds the model from it.
                        "config": dataclasses.asdict(self.exp),
                    },
                    is_best=is_best,
                )
            barrier(self.mesh)
        if self.coordinator:
            self.write_results_csv()
        return self.results

    def write_results_csv(self) -> Optional[str]:
        """The results rows as ``results_dir/metrics-<decoder>(<strategy>-
        inferenceNoTF-Finetuning<layer>-<embedding>).csv``."""
        if not self.results:
            return None
        tc, mc = self.exp.train, self.exp.model
        os.makedirs(tc.results_dir, exist_ok=True)
        strategy = "trainingTF" if tc.teacher_forcing else "trainingNoTF"
        path = os.path.join(
            tc.results_dir,
            f"metrics-{mc.decoder}({strategy}-inferenceNoTF-Finetuning{tc.starting_layer}-{mc.embedding_name}).csv",
        )
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(self.results[0]))
            writer.writeheader()
            writer.writerows(self.results)
        return path
