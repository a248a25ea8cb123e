"""RoleMaker — cluster topology from environment; the port's copy of
``paddle_tpu/distributed/fleet/role_maker.py`` (analog of
python/paddle/distributed/fleet/base/role_maker.py, PaddleCloudRoleMaker):
trainer id/count and endpoints from the PADDLE_* variables the launcher
sets; pserver roles for PS mode.
"""

from __future__ import annotations

import os
from enum import Enum
from typing import List


class Role(Enum):
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class PaddleCloudRoleMaker:
    def __init__(self, is_collective: bool = True, **kwargs):
        self._is_collective = is_collective
        self._role = Role.WORKER
        self._generate_role()

    def _generate_role(self):
        self._trainer_id = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self._trainers_num = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = eps.split(",") if eps else []
        self._current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")
        ps = os.getenv("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = ps.split(",") if ps else []
        training_role = os.getenv("TRAINING_ROLE", "TRAINER")
        if training_role == "PSERVER":
            self._role = Role.SERVER
            self._server_id = int(os.getenv("PADDLE_PORT_ID",
                                            os.getenv("POD_INDEX", "0")))

    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER

    def is_first_worker(self) -> bool:
        return self.is_worker() and self._trainer_id == 0

    def worker_index(self) -> int:
        return self._trainer_id

    def worker_num(self) -> int:
        return self._trainers_num

    def server_num(self) -> int:
        return len(self._server_endpoints)

    def get_trainer_endpoints(self) -> List[str]:
        return self._trainer_endpoints

    def get_pserver_endpoints(self) -> List[str]:
        return self._server_endpoints

    # one process: nothing to wait for (multi-process waits for A5)
    def _barrier(self, comm_world=None):
        pass


UserDefinedRoleMaker = PaddleCloudRoleMaker
