"""A per-test time limit for the PyTorch port's tests: a test that runs
past its module's TIME_LIMIT_S fails with TimeoutError (SIGALRM, on the
main thread, where pytest and its xdist workers run tests).

    from torch_port_time_limit import time_limit  # noqa: F401
    TIME_LIMIT_S = 120
"""
import signal

import pytest


@pytest.fixture(autouse=True)
def time_limit(request):
    limit = int(getattr(request.module, "TIME_LIMIT_S", 120))

    def expire(signum, frame):
        raise TimeoutError(f"{request.node.nodeid}: over its {limit} s "
                           "time limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(limit)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
