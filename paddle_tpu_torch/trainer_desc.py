"""TrainerDesc / DeviceWorker config plane for train_from_dataset — the
port's copy of ``paddle_tpu/trainer_desc.py``.

Analog of python/paddle/fluid/trainer_desc.py:24-343 +
device_worker.py:23-430 + trainer_factory.py. The reference serializes
these into a TrainerDesc proto that configures C++ trainer threads
(MultiTrainer + HogwildWorker etc., trainer.h:41-207). Here the
executor's step (a CUDA graph per key on the card) is the device
worker, so these classes carry the *run* config — fetch vars, print
period, the thread count — and ``Executor.train_from_dataset(
trainer_desc=...)`` consumes them; ``thread_num`` > 1 runs hogwild
workers (the executor's docstring says how they share the card).
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class DeviceWorker:
    """Base device worker config (device_worker.py:23)."""

    name = "DeviceWorker"

    def __init__(self):
        self._fleet_desc = None

    def _set_fleet_desc(self, fleet_desc):
        self._fleet_desc = fleet_desc


class Hogwild(DeviceWorker):
    """Dense hogwild worker (device_worker.py Hogwild): each step
    updates the dense parameters in place; the class selects the plain
    dense path."""

    name = "Hogwild"


class DownpourSGD(DeviceWorker):
    """Sparse PS worker (device_worker.py DownpourSGD): selects the
    distributed_lookup_table pull/push path for sparse tables."""

    name = "DownpourSGD"


class TrainerDesc:
    """Run configuration for Executor.train_from_dataset
    (trainer_desc.py:24)."""

    def __init__(self):
        self._fetch_vars: List = []
        self._fetch_info: List[str] = []
        self._print_period = 100
        self._thread_num = 1
        self._device_worker: DeviceWorker = Hogwild()
        self._infer = False

    # -- reference setter surface -----------------------------------------
    def set_fetch_var_and_info(self, fetch_vars: Sequence,
                               fetch_info: Sequence[str],
                               print_period: int):
        self._fetch_vars = list(fetch_vars)
        self._fetch_info = list(fetch_info)
        self._print_period = int(print_period)

    def set_thread(self, thread_num: int):
        self._thread_num = int(thread_num)

    def set_device_worker(self, worker: DeviceWorker):
        self._device_worker = worker

    def set_infer(self, infer: bool):
        self._infer = bool(infer)


class MultiTrainer(TrainerDesc):
    """Dense multi-thread trainer (trainer_desc.py MultiTrainer):
    ``set_thread(n)`` with n > 1 runs n hogwild workers."""


class DistMultiTrainer(TrainerDesc):
    """PS-mode trainer (trainer_desc.py DistMultiTrainer): pairs with
    DownpourSGD workers."""

    def __init__(self):
        super().__init__()
        self._device_worker = DownpourSGD()


class TrainerFactory:
    """trainer_factory.py analog: build a TrainerDesc from a dataset +
    program opt_info (or defaults)."""

    def create_trainer(self, opt_info: Optional[dict] = None) -> TrainerDesc:
        opt_info = opt_info or {}
        if opt_info.get("use_ps", False):
            trainer: TrainerDesc = DistMultiTrainer()
        else:
            trainer = MultiTrainer()
        if "fetch_var_names" in opt_info:
            trainer.set_fetch_var_and_info(
                opt_info["fetch_var_names"],
                opt_info.get("fetch_info", opt_info["fetch_var_names"]),
                opt_info.get("print_period", 100))
        if "thread_num" in opt_info:
            trainer.set_thread(opt_info["thread_num"])
        return trainer


__all__ = ["DeviceWorker", "DistMultiTrainer", "DownpourSGD", "Hogwild",
           "MultiTrainer", "TrainerDesc", "TrainerFactory"]
