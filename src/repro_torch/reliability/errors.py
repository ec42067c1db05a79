"""Typed errors of the reliability layer.

Every degradation the serve path can take has a distinct exception
type, so callers (and tests) can tell an injected chaos fault from a
real kernel failure from an admission-control rejection without string
matching.  docs/reliability.md maps each to its recovery path.
"""
from __future__ import annotations

__all__ = ["InjectedFault", "KernelFailure", "ShedError"]


class InjectedFault(RuntimeError):
    """A fault fired by :class:`~repro.reliability.faults.FaultInjector`.

    Never raised in production — only when a fault plan is armed.  The
    serve path treats it exactly like the real failure it simulates
    (that equivalence is the point of chaos testing).
    """

    def __init__(self, site: str, kind: str, key: str = "") -> None:
        super().__init__(f"injected {kind} fault at {site}"
                         + (f" ({key})" if key else ""))
        self.site = site
        self.kind = kind
        self.key = key


class KernelFailure(RuntimeError):
    """A compiled kernel crashed or produced non-finite outputs, and the
    retry-after-quarantine budget is spent.

    Carries the blamed primitive (``primitive`` may be None when the
    failure could not be attributed to a single kernel) and the bucket
    the executable was compiled for.
    """

    def __init__(self, bucket: str, primitive=None, detail: str = "") -> None:
        super().__init__(
            f"kernel failure in bucket {bucket}"
            + (f" (primitive {primitive})" if primitive else "")
            + (f": {detail}" if detail else ""))
        self.bucket = bucket
        self.primitive = primitive


class ShedError(RuntimeError):
    """Admission control rejected a request: the modeled backlog says its
    deadline cannot be met, so serving it would only burn capacity on a
    guaranteed SLO miss.

    ``eta_s`` is the modeled completion delay the scheduler projected;
    ``slack_s`` the time the deadline actually allowed.
    """

    def __init__(self, eta_s: float, slack_s: float) -> None:
        super().__init__(
            f"request shed at admission: modeled completion in "
            f"{eta_s * 1e3:.1f}ms exceeds the {slack_s * 1e3:.1f}ms "
            f"deadline slack")
        self.eta_s = float(eta_s)
        self.slack_s = float(slack_s)
