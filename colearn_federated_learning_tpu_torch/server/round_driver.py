"""The experiment driver: the main-path subset of the JAX package's
``server/round_driver.py`` ``Experiment``.

``fit`` runs the rounds (cohort draw → index grid → local training →
weighted mean delta → server apply), logs per-round JSONL records with
the JAX CLI's field names, evaluates every ``server.eval_every`` rounds
and checkpoints; ``evaluate`` / ``evaluate_checkpoint`` score params on
the test split. Everything runs on ``device``, which is CUDA unless the
caller asks for the CPU.

The task follows the dataset: ``classify`` for the image corpora,
``lm`` for Shakespeare, whose int32 token windows and ``[N, T]``
next-token labels stay integer on the device.

Host work per round is the NumPy cohort draw and index grid, pure in
``(seed, round)`` and identical to the JAX package's
``run.host_pipeline="numpy"`` path; the corpus and the eval batches
move to the device once per run. Every round's record names the
``algorithm``.

Under ``attack.kind`` the compromised client set is drawn once from
``run.seed`` (server/attacks.py); ``label_flip`` poisons their labels
before the corpus is placed, and every round marks the cohort slots
they hold. Each attacked round's record carries ``byzantine_count``,
and under Krum ``krum_selected_byzantine`` (1 when the winner was a
compromised slot).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.client.trainer import make_eval_fn
from colearn_federated_learning_tpu_torch.config import ExperimentConfig
from colearn_federated_learning_tpu_torch.data.core import build_federated_data
from colearn_federated_learning_tpu_torch.data.loader import (
    compute_round_shape,
    eval_batches,
    make_round_spec,
    mask_from_spec,
)
from colearn_federated_learning_tpu_torch.models import build_model, init_params
from colearn_federated_learning_tpu_torch.parallel.round_engine import (
    make_sequential_round_fn,
)
from colearn_federated_learning_tpu_torch.server.aggregation import (
    make_server_update_fn,
)
from colearn_federated_learning_tpu_torch.server.attacks import (
    UPLOAD_ATTACKS,
    flip_labels,
    select_compromised,
)
from colearn_federated_learning_tpu_torch.server.sampler import CohortSampler
from colearn_federated_learning_tpu_torch.utils.checkpoint import (
    CheckpointStore,
)
from colearn_federated_learning_tpu_torch.utils.device import (
    DTYPES,
    resolve_device,
)
from colearn_federated_learning_tpu_torch.utils.metrics import MetricsLogger
from colearn_federated_learning_tpu_torch.utils.trees import ParamLayout


class Experiment:
    def __init__(self, cfg: ExperimentConfig, device: str = "cuda",
                 echo: bool = True):
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 convolutions and matmuls in full f32 (cuDNN's default
            # is TF32), and heuristic — not benchmarked — conv algorithm
            # choice, so fit's last eval and a later evaluate of its
            # checkpoint pick the same algorithms and agree bit for bit
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.benchmark = False
        self.model = build_model(
            cfg.model.name, cfg.model.num_classes,
            compute_dtype=DTYPES[cfg.run.compute_dtype], **cfg.model.kwargs,
        )
        self.layout = ParamLayout.from_params(dict(self.model.named_parameters()))
        self.fed = build_federated_data(cfg.data, seed=cfg.run.seed,
                                        **cfg.model.kwargs)
        self.attack_kind = cfg.attack.kind
        self.compromised = None
        # round → the cohort's byzantine mask, until its record is logged
        self._byz_masks: Dict[int, np.ndarray] = {}
        if self.attack_kind:
            self.compromised = select_compromised(
                self.fed.num_clients, cfg.attack.fraction, cfg.run.seed)
            if self.attack_kind == "label_flip":
                if self.fed.task != "classify":
                    raise ValueError("attack.kind='label_flip' requires a "
                                     "classification task")
                self.fed.train_y = flip_labels(
                    self.fed.train_y, self.fed.client_indices,
                    self.compromised, self.fed.num_classes)
        upload_attack = (self.attack_kind
                         if self.attack_kind in UPLOAD_ATTACKS else "")
        self.shape = compute_round_shape(self.fed, cfg.client, cfg.data)
        self.sampler = CohortSampler(
            self.fed.num_clients, cfg.server.cohort_size, seed=cfg.run.seed)
        self.server_opt_init, server_update = make_server_update_fn(cfg.server)
        local_dtype = (DTYPES[cfg.run.local_param_dtype]
                       if cfg.run.local_param_dtype else None)
        self.round_fn = make_sequential_round_fn(
            self.model, cfg.client, server_update, self.layout, local_dtype,
            aggregator=cfg.server.aggregator,
            trim_ratio=cfg.server.trim_ratio,
            byzantine_f=cfg.server.krum_byzantine, attack=upload_attack,
            attack_scale=cfg.attack.scale, attack_eps=cfg.attack.eps,
            task=self.fed.task)
        self._eval_fn = make_eval_fn(self.model, self.fed.task)
        dev = self.device
        self.train_x = torch.from_numpy(self.fed.train_x).to(dev)
        self.train_y = torch.from_numpy(self.fed.train_y).long().to(dev)
        xb, yb, mb = eval_batches(
            self.fed.test_x, self.fed.test_y, cfg.client.batch_size)
        self._eval_data = tuple(
            torch.from_numpy(a).to(dev) for a in (xb, yb.astype(np.int64), mb))
        self.logger = MetricsLogger(cfg.run.out_dir or None, cfg.name,
                                    echo=echo)

    # ---- state ----------------------------------------------------------

    def init_state(self) -> Dict[str, Any]:
        """Fresh params from ``run.seed`` (flax's initializers)."""
        flat = self.layout.flatten(init_params(self.model, self.cfg.run.seed),
                                   device=self.device)
        return self.state_from_flat(flat)

    def state_from_flat(self, flat: torch.Tensor,
                        round_idx: int = 0) -> Dict[str, Any]:
        opt = self.server_opt_init(flat)
        opt["round"] = round_idx
        return {"params": flat, "server_opt_state": opt, "round": round_idx}

    # ---- rounds ---------------------------------------------------------

    def _round_inputs(self, round_idx: int):
        """Host work for one round, pure in (seed, round): the cohort,
        its ``[K, steps, batch]`` index grid and validity mask, the
        example counts, and the per-step counts the trainer gates on."""
        cohort = self.sampler.sample(round_idx)
        host_rng = np.random.default_rng((self.cfg.run.seed, 7919, round_idx))
        idx, spec, n_ex = make_round_spec(self.fed, cohort, self.shape,
                                          host_rng)
        mask = mask_from_spec(spec, self.shape)
        step_counts = mask.sum(-1)
        idx_d = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        mask_d = torch.from_numpy(mask).to(self.device)
        return cohort, idx_d, mask_d, n_ex, step_counts

    def run_round(self, state: Dict[str, Any], round_idx: int
                  ) -> Dict[str, Any]:
        """One round. The params buffer is updated in place; the returned
        state carries the round's metrics under ``_metrics``."""
        cohort, idx, mask, n_ex, step_counts = self._round_inputs(round_idx)
        byz = None
        if self.attack_kind:
            # the cohort slots the adversary owns this round
            byz = np.isin(np.asarray(cohort), self.compromised)
            self._byz_masks[round_idx] = byz
            byz = byz.astype(np.float32)
        opt_state, metrics = self.round_fn(
            state["params"], state["server_opt_state"], self.train_x,
            self.train_y, idx, mask, n_ex, step_counts, byz)
        return {"params": state["params"], "server_opt_state": opt_state,
                "round": round_idx + 1, "_metrics": metrics}

    def _run_dir(self) -> str:
        return os.path.join(self.cfg.run.out_dir or ".", self.cfg.name)

    def _ckpt_store(self) -> CheckpointStore:
        return CheckpointStore(os.path.join(self._run_dir(), "ckpt"))

    def fit(self, state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        cfg = self.cfg
        store = self._ckpt_store() if cfg.run.out_dir else None
        if state is None:
            state = self.init_state()
        self.logger.log({
            "event": "precision", "compute_dtype": cfg.run.compute_dtype,
            "local_param_dtype": cfg.run.local_param_dtype or "float32",
            "param_dtype": "float32",
            "device": str(self.device), "fused_apply": cfg.server.fused_apply,
        })
        if self.attack_kind and int(state["round"]) == 0:
            # attack provenance: kind, knobs and the compromised set
            self.logger.log({
                "event": "attack", "kind": self.attack_kind,
                "fraction": cfg.attack.fraction, "scale": cfg.attack.scale,
                "eps": cfg.attack.eps,
                "n_compromised": int(len(self.compromised)),
                "compromised": [int(c) for c in self.compromised],
            })
        flush_every = max(1, cfg.run.metrics_flush_every)
        pending: List[Tuple[int, Any]] = []
        t_start = flush_t0 = time.perf_counter()

        def flush(current):
            nonlocal flush_t0
            if not pending:
                return
            losses = torch.stack([m.train_loss for _, m in pending]).cpu()
            winners = [None if m.krum_winner is None else int(m.krum_winner)
                       for _, m in pending]
            dt = time.perf_counter() - flush_t0
            rounds_per_sec = len(pending) / dt if dt > 0 else 0.0
            for j, (ridx, m) in enumerate(pending):
                record = {"round": ridx + 1, "algorithm": cfg.algorithm,
                          "train_loss": float(losses[j]),
                          "examples": float(m.examples)}
                byz = self._byz_masks.pop(ridx, None)
                if byz is not None:
                    # compromised clients sampled into this round's cohort
                    record["byzantine_count"] = int(byz.sum())
                    if winners[j] is not None:
                        record["krum_selected_byzantine"] = int(
                            byz[winners[j]])
                if ridx == pending[-1][0]:
                    record["rounds_per_sec"] = round(rounds_per_sec, 4)
                    record["client_updates_per_sec_per_chip"] = round(
                        rounds_per_sec * cfg.server.cohort_size, 4)
                    if cfg.server.eval_every and (
                            (ridx + 1) % cfg.server.eval_every == 0):
                        record.update(self.evaluate(current["params"]))
                self.logger.log(record)
            pending.clear()
            flush_t0 = time.perf_counter()

        start = int(state["round"])
        saved = None
        for r in range(start, cfg.server.num_rounds):
            state = self.run_round(state, r)
            pending.append((r, state.pop("_metrics")))
            r_end = r + 1
            at_eval = cfg.server.eval_every and r_end % cfg.server.eval_every == 0
            at_ckpt = (store is not None and cfg.server.checkpoint_every
                       and r_end % cfg.server.checkpoint_every == 0)
            if (len(pending) >= flush_every or at_eval or at_ckpt
                    or r_end == cfg.server.num_rounds):
                flush(state)
            if at_ckpt:
                self.save_checkpoint(store, state)
                saved = r_end
                flush_t0 = time.perf_counter()
        flush(state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        state["wall_time"] = time.perf_counter() - t_start
        if store is not None and saved != int(state["round"]):
            self.save_checkpoint(store, state)
        self.logger.log({"event": "run_summary", "rounds": int(state["round"]),
                         "wall_time_sec": round(state["wall_time"], 3)})
        return state

    # ---- checkpoints ------------------------------------------------------

    def save_checkpoint(self, store: CheckpointStore,
                        state: Dict[str, Any]) -> str:
        opt = state["server_opt_state"]
        return store.save(int(state["round"]), {
            "params": state["params"].detach().cpu(),
            "param_names": list(self.layout.names),
            "param_shapes": [list(s) for s in self.layout.shapes],
            "server_opt_state": {
                "round": int(opt["round"]),
                "opt": {k: v.detach().cpu() for k, v in opt["opt"].items()},
            },
            "round": int(state["round"]),
            "sampler": {"seed": int(self.sampler.seed),
                        "num_clients": int(self.sampler.num_clients),
                        "cohort_size": int(self.sampler.cohort_size)},
        })

    def load_checkpoint(self) -> Dict[str, Any]:
        """The state of the run's latest checkpoint, on ``device``."""
        ckpt = self._ckpt_store().restore()
        names = tuple(ckpt["param_names"])
        shapes = tuple(tuple(s) for s in ckpt["param_shapes"])
        if names != self.layout.names or shapes != self.layout.shapes:
            raise ValueError(
                "checkpoint parameters do not match this config's model "
                "(names or shapes differ)")
        state = self.state_from_flat(ckpt["params"].to(self.device),
                                     int(ckpt["round"]))
        opt = ckpt["server_opt_state"]
        state["server_opt_state"] = {
            "round": int(opt["round"]),
            "opt": {k: v.to(self.device) for k, v in opt["opt"].items()},
        }
        return state

    # ---- eval -------------------------------------------------------------

    def evaluate(self, params: torch.Tensor) -> Dict[str, float]:
        """Loss and accuracy over the whole (padded, masked) test split."""
        views = self.layout.views(params)
        xb, yb, mb = self._eval_data
        acc = torch.zeros(3, dtype=torch.float32, device=self.device)
        for b in range(xb.shape[0]):
            acc += torch.stack(self._eval_fn(views, xb[b], yb[b], mb[b]))
        loss, correct, n = acc.cpu().numpy()
        return {"eval_loss": float(loss / n), "eval_acc": float(correct / n)}

    def evaluate_checkpoint(self) -> Dict[str, Any]:
        state = self.load_checkpoint()
        out = self.evaluate(state["params"])
        out["round"] = int(state["round"])
        return out
