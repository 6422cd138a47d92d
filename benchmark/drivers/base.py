"""What every driver gives the harness besides its requests: the windows a
request completes and the work of a request by layer, both from the
configuration and the traffic alone. A step kind that does not count its
own work raises here rather than borrow another kind's counts."""

from __future__ import annotations

from typing import Dict

from benchmark.work import Work


class Driver:
    @classmethod
    def windows_per_request(cls, conf: dict, traffic: dict) -> int:
        raise NotImplementedError(
            f"{cls.__module__}: the step kind gives no windows a request")

    @classmethod
    def work(cls, conf: dict, traffic: dict) -> Dict[str, Work]:
        """Work of one request by layer, each layer named as its folder of
        ``benchmark/kernels/``."""
        raise NotImplementedError(
            f"{cls.__module__}: the step kind counts no work")
