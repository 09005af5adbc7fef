"""Cost-based adaptive planner: the control-flow side of the cost ledger.

No reference analog — the reference chooses execution strategies with
build-time constants.  This package closes ROADMAP item 4's feedback
loop: the :class:`~pilosa_tpu_torch.costs.CostLedger` stops being pure
telemetry and starts driving decisions.

Three consumers of measured cost, one per module:

- :class:`~pilosa_tpu_torch.planner.core.Planner` — per (index, fingerprint)
  strategy-lane selection for the executor's fused count paths ("gram"
  slice-major family vs "rmgather" row-major gather), confidence-gated
  with hysteresis, every outcome folded back into the ledger.  Decisions
  are made at the FRONT DOOR (server handler, lockstep rank 0) and ride
  ``ExecOptions.plan`` — the executor itself never consults, so lockstep
  workers replay rank 0's plan off the batch wire exactly like expiry
  and sampling flags.
- :class:`~pilosa_tpu_torch.planner.prearm.PreArmer` — hot (index, frame)
  serve states re-armed asynchronously after invalidating writes, under
  a drain budget (the bulk door's materialize budget pattern), instead of
  paying cold-start on the next read.
- :class:`~pilosa_tpu_torch.planner.budgets.AdaptiveBudgets` — qcache
  admission floor, catch-up drain batch, and resync chunk size derived
  from measured cost/bandwidth instead of constants, each clamped
  around its static default and falling back to it exactly while the
  ledger is empty.

Knobs live in ``config.py`` ([planner] section / PILOSA_TPU_PLANNER_*);
``/debug/planner`` serves decision state.  See DEVELOPMENT.md
("Cost-based adaptive planner").
"""

from pilosa_tpu_torch.planner.budgets import AdaptiveBudgets
from pilosa_tpu_torch.planner.core import PLAN_LANES, Planner
from pilosa_tpu_torch.planner.prearm import PreArmer

__all__ = ["AdaptiveBudgets", "PLAN_LANES", "Planner", "PreArmer"]
