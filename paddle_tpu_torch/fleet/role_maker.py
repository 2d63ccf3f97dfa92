"""Role makers (counterpart: `paddle_tpu/fleet/role_maker.py`; reference:
`python/paddle/fluid/incubate/fleet/base/role_maker.py:68-988`):
PaddleCloud env-based (:477) and user-defined.

The worker set is the PADDLE_* env contract, one process per device
(`distributed/launch.py` sets it).
"""
from __future__ import annotations

import os


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._worker_endpoints = []
        self._server_endpoints = []
        self._role = Role.WORKER
        self._current_id = 0

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return max(len(self._worker_endpoints), 1)

    def server_num(self):
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        return self._worker_endpoints

    def get_pserver_endpoints(self):
        return self._server_endpoints

    def generate_role(self):
        pass

    def barrier_worker(self):
        pass

    def barrier_all(self):
        pass


class PaddleCloudRoleMaker(RoleMakerBase):
    """Env-var driven (reference: role_maker.py:477): PADDLE_TRAINER_ID,
    PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS[, PADDLE_PORT/IP for PS
    mode]."""

    def __init__(self, is_collective=True):
        super().__init__()
        self._is_collective = is_collective
        self.generate_role()

    def generate_role(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = eps.split(",") if eps else []
        ps_eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = ps_eps.split(",") if ps_eps else []
        role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        if role == "PSERVER" and not self._is_collective:
            # reference role_maker.py:477: a pserver identifies itself
            # by POD_IP:PADDLE_PORT within the server list
            self._role = Role.SERVER
            me = "%s:%s" % (os.environ.get("POD_IP", "127.0.0.1"),
                            os.environ.get("PADDLE_PORT", "0"))
            self._current_id = (self._server_endpoints.index(me)
                                if me in self._server_endpoints else 0)
        else:
            self._role = Role.WORKER
            self._current_id = int(os.environ.get("PADDLE_TRAINER_ID",
                                                  "0"))

    def worker_num(self):
        return int(os.environ.get(
            "PADDLE_TRAINERS_NUM",
            str(max(len(self._worker_endpoints), 1))))


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._worker_num = worker_num
        self._server_endpoints = server_endpoints or []

    def worker_num(self):
        return self._worker_num


class UserDefinedCollectiveRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, worker_endpoints=None):
        super().__init__()
        self._current_id = current_id
        self._worker_endpoints = worker_endpoints or []
