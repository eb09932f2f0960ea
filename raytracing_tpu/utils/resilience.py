"""Failure detection and elastic recovery for long-running renders/fits.

The reference has none of this — errors are `unwrap()`/`process::exit`
(/root/reference/src/main.rs:46,:497-500) and all state dies with the
process (SURVEY.md §5). A production render service needs more: the
device sits behind a runtime that can drop, hang, or be preempted
independently of the host process. This module provides the
three primitives the app/fit loops build recovery from:

  * `device_alive()` — cheap liveness probe: one tiny op on the target
    backend under a wall-clock deadline (run in a worker thread so a hung
    runtime can't hang the probe itself).
  * `with_retry(fn)` — transient-fault barrier: retries XLA runtime
    errors with exponential backoff, optionally re-probing liveness
    between attempts; raises `DeviceLost` once attempts are exhausted so
    callers can checkpoint and exit cleanly instead of stack-tracing.
  * `Supervisor` — composes the two with utils.checkpoint for elastic
    loops: `run_step` executes a step under retry; on unrecoverable
    device loss it writes a final checkpoint and re-raises. A restarted
    process resumes from that checkpoint (`fit --resume`), which is the
    analog of elastic training-job recovery: state lives in host
    checkpoints, the device is disposable.

Everything is host-side python (no jit interaction): the unit of retry is
a whole dispatched step, which is the granularity at which the XLA
runtime surfaces device loss.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional

log = logging.getLogger("raytracing_tpu.resilience")

# The runtime surfaces device trouble as jaxlib XlaRuntimeError (a
# subclass of RuntimeError in current jaxlib) or plain OSError for
# transport-level failures; match conservatively on type + message so an
# unrelated ValueError in user code is never swallowed.
_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED", "INTERNAL",
    "ABORTED", "CANCELLED", "device", "Device", "transport", "connection",
)


class DeviceLost(RuntimeError):
    """Raised when retries are exhausted: the device is considered gone.

    Carries `last_error` (the final underlying exception) and, when a
    Supervisor is involved, `checkpoint_path` of the state snapshot taken
    before giving up.
    """

    def __init__(self, msg: str, last_error: Optional[BaseException] = None,
                 checkpoint_path: Optional[str] = None):
        super().__init__(msg)
        self.last_error = last_error
        self.checkpoint_path = checkpoint_path


def is_transient(err: BaseException) -> bool:
    """Heuristic: is this exception a runtime/device fault worth retrying
    (vs. a programming error that will deterministically recur)?"""
    if isinstance(err, (FloatingPointError, ValueError, TypeError)):
        return False
    if not isinstance(err, (RuntimeError, OSError, TimeoutError)):
        return False
    text = f"{type(err).__name__}: {err}"
    return any(m in text for m in _TRANSIENT_MARKERS)


def device_alive(timeout_s: float = 30.0, backend: Optional[str] = None
                 ) -> bool:
    """Probe device liveness: run `1+1` on `backend` (default: the default
    backend) inside a worker thread with a wall-clock deadline. A hung
    runtime (e.g. a stuck remote claim) makes ordinary calls block
    forever; the thread-plus-deadline turns that hang into `False`."""
    result: list[bool] = []

    def probe() -> None:
        try:
            import jax
            import jax.numpy as jnp

            dev = jax.devices(backend)[0] if backend else jax.devices()[0]
            x = jax.device_put(jnp.ones(()), dev)
            jax.block_until_ready(x + 1)
            result.append(True)
        except Exception:  # noqa: BLE001 — any failure means "not alive"
            result.append(False)

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    return bool(result and result[0])


def with_retry(
    fn: Callable[[], Any],
    retries: int = 3,
    backoff_s: float = 1.0,
    backoff_factor: float = 2.0,
    probe: bool = False,
    probe_timeout_s: float = 30.0,
) -> Any:
    """Run `fn()` retrying transient runtime faults.

    Deterministic errors (wrong shapes, NaN checks, ...) propagate
    immediately. Transient ones are retried up to `retries` times with
    exponential backoff; with `probe=True` each retry first waits for
    `device_alive()` (so a momentary runtime blip doesn't burn every
    attempt inside one dead window). Raises DeviceLost when exhausted."""
    delay = backoff_s
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        if attempt and probe and not device_alive(probe_timeout_s):
            log.warning("device not alive before retry %d; waiting", attempt)
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — filtered just below
            if not is_transient(e):
                raise
            last = e
            if attempt == retries:
                break
            log.warning("transient device fault (attempt %d/%d): %s; "
                        "retrying in %.1fs", attempt + 1, retries, e, delay)
            time.sleep(delay)
            delay *= backoff_factor
    raise DeviceLost(
        f"device fault persisted through {retries} retries", last_error=last)


class Supervisor:
    """Elastic-recovery harness for step loops (fit, animate).

    Wraps each step in `with_retry`; when the device is finally declared
    lost, snapshots `state_fn()` via utils.checkpoint to `checkpoint_path`
    and raises DeviceLost carrying that path. A fresh process resumes from
    the checkpoint — state outlives the device, the elasticity
    model (SURVEY.md §5: reference has nothing; we define the contract).
    """

    def __init__(
        self,
        checkpoint_path: str,
        state_fn: Callable[[], dict],
        retries: int = 3,
        backoff_s: float = 1.0,
        checkpoint_every: int = 0,
    ):
        self.checkpoint_path = checkpoint_path
        self.state_fn = state_fn
        self.retries = retries
        self.backoff_s = backoff_s
        self.checkpoint_every = checkpoint_every
        self.step = 0

    def _snapshot(self) -> str:
        from raytracing_tpu.utils import checkpoint as ckpt

        st = self.state_fn()
        ckpt.save(self.checkpoint_path, st.get("params"),
                  st.get("opt_state"), step=self.step,
                  metadata=st.get("metadata"))
        return self.checkpoint_path

    def run_step(self, fn: Callable[[], Any]) -> Any:
        """Execute one step under retry; periodic + failure checkpoints."""
        try:
            out = with_retry(fn, retries=self.retries,
                             backoff_s=self.backoff_s)
        except DeviceLost as e:
            path = self._snapshot()
            log.error("device lost at step %d; state checkpointed to %s",
                      self.step, path)
            raise DeviceLost(str(e), last_error=e.last_error,
                             checkpoint_path=path) from e
        self.step += 1
        if self.checkpoint_every and self.step % self.checkpoint_every == 0:
            self._snapshot()
        return out
