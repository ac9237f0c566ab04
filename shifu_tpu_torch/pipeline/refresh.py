"""`refresh` step — the port's copy of ``shifu_tpu.pipeline.refresh``:
the continual-refresh controller as a pipeline step.

``refresh`` runs one cycle attempt (trigger check → warm retrain → AUC
gate → promote → probation) and exits; ``--daemon`` keeps the controller
resident, polling the drift artifact and the schedule.  The retrain and
the gate run on the step's device (``cuda`` unless ``--device cpu``):
the appended GBT trees' histograms through B1, the replay of the
restored forest and the gate's holdout scores through B4.

The step runs in registry mode: promotions and rollbacks commit the
``<modelset>/serving/serving.json`` journal (scorers build without their
captured rungs: the controller process serves nothing); a serving fleet
re-resolves the journal through ``ModelRegistry.restore`` on restart, and
probation reads the fleet's SERVE heartbeats for SLO burn.  An
in-process server attaches through
:class:`shifu_tpu_torch.refresh.RefreshController` directly instead.
"""

from __future__ import annotations

import logging
import os

from ..config.validator import ModelStep
from .processor import BasicProcessor

log = logging.getLogger(__name__)


class RefreshProcessor(BasicProcessor):
    step = ModelStep.REFRESH

    def process(self) -> int:
        from ..config.errors import ErrorCode, ShifuError
        from ..refresh import RefreshController, drift_columns_for
        from ..serve.registry import ModelRegistry

        models_dir = self.paths.models_dir
        if not any(f.startswith("model")
                   for f in (os.listdir(models_dir)
                             if os.path.isdir(models_dir) else [])):
            raise ShifuError(
                ErrorCode.ERROR_MODEL_FILE_NOT_FOUND,
                "`refresh` needs a trained incumbent — run `train` "
                "first")
        key = os.path.basename(os.path.abspath(self.dir))
        registry = ModelRegistry(
            state_dir=os.path.join(self.dir, "serving"), device=self.device)
        # registry mode: no captured rungs in the controller process — the
        # serving fleet re-resolves serving.json and captures its own
        registry.restore(key, models_dir, warm=False)
        ctrl = RefreshController(
            self.dir, registry=registry, key=key, warm=False,
            drift_columns=drift_columns_for(self.dir))
        poll = float(self.params.get("poll") or 2.0)
        ctrl.start()
        try:
            if self.params.get("daemon"):
                log.info("refresh daemon up: key=%s poll=%.1fs "
                         "(interrupt to stop)", key, poll)
                try:
                    ctrl.run(poll_s=poll)
                except KeyboardInterrupt:
                    log.info("refresh daemon stopped")
                return 0
            outcome = ctrl.run_once(poll_s=poll)
            log.info("refresh cycle outcome: %s (generation %d)",
                     outcome, registry.generation(key))
            return 0
        finally:
            ctrl.stop()
