"""RemoteFunction: the `@ray_tpu_torch.remote` task wrapper.

Reference: ray python/ray/remote_function.py (RemoteFunction._remote :266 →
core_worker.submit_task :435) with `.options(...)` overrides
(remote_function.py:160) validated by ray_option_utils.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private import ray_option_utils as opts
from ray_tpu_torch._raylet import get_core_worker
from ray_tpu_torch._private.specs import SchedulingStrategySpec
from ray_tpu_torch.util.scheduling_strategies import to_spec


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._function = fn
        self._options = opts.validate_options(options or {}, is_actor=False)
        # Export cache is keyed by worker session: module-level remote
        # functions outlive ray_tpu_torch.init/shutdown cycles, and each new
        # cluster's GCS needs its own export.
        self._function_id: Optional[str] = None
        self._exported_session: Optional[bytes] = None
        self._prepared_env: Optional[dict] = None
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._function.__name__}' cannot be called "
            "directly; use .remote()."
        )

    def options(self, **overrides) -> "RemoteFunction":
        merged = opts.merge_options(self._options, overrides)
        # No session-state copy: overrides may change runtime_env, so the
        # derived function must re-run the prepare-once branch on first
        # .remote() (function registration is content-hashed and cached, so
        # re-export is cheap).
        return RemoteFunction(self._function, merged)

    def remote(self, *args, **kwargs):
        cw = get_core_worker()
        session = cw.worker_id.binary()
        if self._function_id is None or self._exported_session != session:
            self._function_id = cw.register_function(self._function)
            self._exported_session = session
            # Prepare (validate + merge job default + package dirs) ONCE per
            # session, not per submission — runtime-env prep involves
            # hashing/validation that doesn't belong on the hot submit path.
            self._prepared_env = cw.prepare_runtime_env(
                self._options.get("runtime_env"))
        o = self._options
        num_returns = o.get("num_returns", 1)
        strategy = to_spec(o.get("scheduling_strategy"), o)
        result = cw.submit_task(
            self._function,
            args,
            kwargs,
            num_returns=num_returns,
            resources=opts.resources_from_options(o, is_actor=False),
            max_retries=o.get("max_retries", 3),
            retry_exceptions=bool(o.get("retry_exceptions", False)),
            max_calls=int(o.get("max_calls", 0)),
            deadline_s=o.get("deadline_s"),
            scheduling_strategy=strategy,
            name=o.get("name") or self._function.__name__,
            function_id=self._function_id,
            runtime_env=self._prepared_env,
            runtime_env_prepared=True,
        )
        if isinstance(result, list):
            if num_returns == 1:
                return result[0]
            if num_returns == 0:
                return None
        return result

    @property
    def _underlying(self):
        return self._function
