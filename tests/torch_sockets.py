"""A per-test time limit for the port's socket tests: a test that talks to
a real socket and hangs fails with ``TimeoutError`` after ``SOCKET_TEST_S``
seconds instead of holding its worker until the run's own limit."""

import signal

import pytest

SOCKET_TEST_S = 60.0


@pytest.fixture(autouse=True)
def socket_time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"socket test ran past {SOCKET_TEST_S} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, SOCKET_TEST_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
