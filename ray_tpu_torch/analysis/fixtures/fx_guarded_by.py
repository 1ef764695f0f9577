"""Seeded violations for the guarded_by pass (parsed, never imported).

Expected findings:
- unguarded-access  Counter.n read in bad() without self._lock

Non-findings: good() holds the lock, helper() declares `# holds: _lock`,
peek() is suppressed with `# unguarded-ok`, __init__ is exempt.
"""

import threading


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0          # guarded-by: _lock

    def good(self):
        with self._lock:
            self.n += 1
            return self.n

    def bad(self):
        return self.n

    def helper(self):       # holds: _lock
        self.n -= 1

    def peek(self):
        return self.n       # unguarded-ok
