"""Developer tools of the port (counterpart of ray_tpu/devtools).

* ``lint`` — the AST rule engine (``python -m ray_tpu_torch.devtools.lint``)
  with its rule families: usage anti-patterns (RT1xx, ``rules_user``),
  invariants of the framework's own source (RT2xx, ``rules_internal``),
  resource release over ``dataflow``'s CFG (RT3xx, ``rules_dataflow``),
  guarded-by discipline over its lock analysis (RT4xx,
  ``rules_concurrency``) and the eager-torch rules (RT5xx, ``rules_torch``).
* ``lockdebug`` — opt-in runtime lock instrumentation: the lock-order
  detector (``RAY_TPU_DEBUG_LOCKS=1``) and the contention profiler
  (``RAY_TPU_LOCK_PROFILE=1``).
* ``syncdebug`` — the CUDA host-sync tripwire (``RAY_TPU_SYNC_DEBUG=1``).

The leak sanitizer, the runtime twin of RT3xx, is ``ray_tpu_torch._sanitizer``
(``RAY_TPU_SANITIZE=1``).
"""

from .lint import (Finding, LintResult, Rule, iter_rules, lint_paths,
                   lint_source)

__all__ = ["Finding", "LintResult", "Rule", "iter_rules", "lint_paths",
           "lint_source"]
