"""A per-test time limit for the port's live fleet tests.

``@time_limit(60)`` fails the test with ``TimeoutError`` once it has run
60 seconds (SIGALRM in the main thread, where pytest and its xdist workers
run tests), so a wedged fleet costs one test, never the whole run.
"""

import functools
import signal


def time_limit(seconds):
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            def expire(signum, frame):
                raise TimeoutError(f"{fn.__name__} exceeded its {seconds}s limit")

            previous = signal.signal(signal.SIGALRM, expire)
            signal.setitimer(signal.ITIMER_REAL, seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, previous)

        return run

    return wrap
