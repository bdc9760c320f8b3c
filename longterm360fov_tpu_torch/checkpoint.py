"""Checkpoint and resume with ``torch.save``.

PyTorch twin of ``longterm360fov_tpu.checkpoint`` (which uses orbax): each
checkpoint is ``<directory>/<step>/state.pt`` holding the params, the
optimizer state, the step and the generator state, with its metrics, when
given, in ``metrics.json`` beside it. ``config.json`` keeps the same keys as
the JAX package's (``name``, ``hash``, ``model_hash``). Restore is exact: a
resumed run continues bit for bit from the saved step, a ``--bf16`` model's
too, whose f32 moments (those of the LSTM cells the kernels train) are
restored in f32 where orbax's restore into the fresh state's bf16 moments
rounds them (ROADMAP.md, known divergences).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional

import torch

from .config import ExperimentConfig
from .params import tree_leaves, tree_unflatten
from .train import AdamState, TrainState

__all__ = ["Checkpointer"]


class Checkpointer:
    def __init__(
        self,
        directory: str,
        cfg: ExperimentConfig,
        keep: int = 3,
        best_metric: Optional[str] = None,
        best_mode: str = "min",
    ):
        """Keeps the ``keep`` most recent checkpoints, or with
        ``best_metric`` (a key of the metrics passed to :meth:`save`, e.g.
        "eval_great_circle_deg") the ``keep`` best by that value; ones saved
        without metrics are kept."""
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got {best_mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.cfg = cfg
        self.keep = keep
        self.best_metric = best_metric
        self.best_mode = best_mode
        meta_path = os.path.join(self.directory, "config.json")
        if not os.path.exists(meta_path):
            with open(meta_path, "w") as f:
                json.dump(
                    {"name": cfg.name, "hash": cfg.hash(), "model_hash": cfg.model_hash()},
                    f,
                )

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, state: TrainState, metrics: Optional[dict] = None) -> None:
        """Write the state (on the CPU), then drop what retention does not
        keep. The step's directory appears complete or not at all."""
        final = self._step_dir(state.step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        opt = state.opt_state
        torch.save(
            {
                "params": [p.detach().cpu() for p in tree_leaves(state.params)],
                "opt_count": opt.count,
                "opt_mu": [m.cpu() for m in opt.mu],
                "opt_nu": [v.cpu() for v in opt.nu],
                "step": state.step,
                "rng": state.rng.get_state(),
            },
            os.path.join(tmp, "state.pt"),
        )
        if metrics is not None:
            with open(os.path.join(tmp, "metrics.json"), "w") as f:
                json.dump(metrics, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._retain()

    def _metrics(self, step: int) -> Optional[dict]:
        path = os.path.join(self._step_dir(step), "metrics.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def _retain(self) -> None:
        steps = self.all_steps()
        if self.best_metric is None:
            drop = steps[: max(len(steps) - self.keep, 0)]
        else:
            scored = [s for s in steps if self.best_metric in (self._metrics(s) or {})]
            scored.sort(
                key=lambda s: self._metrics(s)[self.best_metric],
                reverse=self.best_mode == "max",
            )
            drop = scored[self.keep:]
        for s in drop:
            shutil.rmtree(self._step_dir(s))

    def all_steps(self) -> List[int]:
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and os.path.exists(os.path.join(self._step_dir(int(name)), "state.pt"))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The kept step with the best metric; the latest step without a
        ``best_metric``, as orbax's manager answers."""
        if self.best_metric is None:
            return self.latest_step()
        scored = [
            (m[self.best_metric], s) for s in self.all_steps()
            if self.best_metric in (m := self._metrics(s) or {})
        ]
        if not scored:
            return None
        pick = min if self.best_mode == "min" else max
        return pick(scored)[1]

    def restore(self, state_like: TrainState, step: Optional[int] = None) -> TrainState:
        """Restore into the structure and devices of ``state_like`` (a
        freshly initialized TrainState): the params in its dtypes, the
        optimizer's moments in the dtypes they were saved in, which the
        updates may have promoted (``train.make_optimizer``)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        saved = torch.load(
            os.path.join(self._step_dir(step), "state.pt"), map_location="cpu",
            weights_only=True,
        )

        def like(tensors, refs, saved_dtypes=False):
            if len(tensors) != len(refs):
                raise ValueError(f"checkpoint has {len(tensors)} tensors, the state {len(refs)}")
            out = []
            for t, r in zip(tensors, refs):
                if t.shape != r.shape:
                    raise ValueError(f"checkpoint tensor {tuple(t.shape)} vs state {tuple(r.shape)}")
                out.append(t.to(device=r.device, dtype=t.dtype if saved_dtypes else r.dtype))
            return out

        params = tree_unflatten(
            state_like.params, like(saved["params"], tree_leaves(state_like.params))
        )
        opt = AdamState(
            saved["opt_count"],
            like(saved["opt_mu"], state_like.opt_state.mu, saved_dtypes=True),
            like(saved["opt_nu"], state_like.opt_state.nu, saved_dtypes=True),
        )
        rng = torch.Generator()
        rng.set_state(saved["rng"])
        return TrainState(params, opt, saved["step"], rng)

    def _meta(self) -> dict:
        meta_path = os.path.join(self.directory, "config.json")
        if not os.path.exists(meta_path):
            return {}
        with open(meta_path) as f:
            return json.load(f)

    def check_config(self) -> bool:
        """True when the on-disk full config hash matches this experiment
        (architecture and training hyperparameters)."""
        meta = self._meta()
        return not meta or meta.get("hash") == self.cfg.hash()

    def check_model_config(self) -> bool:
        """True when the on-disk model hash matches, i.e. the params in this
        directory mean what this experiment's architecture expects. A missing
        key passes. A hash written before peer counts left the model hash is
        accepted for the current peer count, except for a ``peer_align``
        config, which postdates that era."""
        meta = self._meta()
        saved = meta.get("model_hash")
        if saved is None or saved == self.cfg.model_hash():
            return True
        if getattr(self.cfg.model, "peer_align", False):
            return False
        return saved == self.cfg.model_hash(_legacy_peers=self.cfg.n_other_users)
