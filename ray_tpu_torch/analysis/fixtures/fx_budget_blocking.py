"""Seeded violations for the budget-promotion rule (parsed, never
imported).

``kv_put`` is in rpc_stats.HANDLER_BUDGETS_MS, ``wait_thing`` is not.
Expected findings:
- lock-held-blocking    in h_kv_put AND h_wait_thing (time.sleep under
                        MiniServer.lock)
- budget-held-blocking  ONLY in h_kv_put — the handler of a budgeted
                        RPC; the unbudgeted handler stays a plain
                        (baselinable) lock-held-blocking warning
"""

import threading
import time


class MiniServer:
    def __init__(self, server):
        self.lock = threading.Lock()
        server.handle("kv_put", self.h_kv_put)          # budgeted
        server.handle("wait_thing", self.h_wait_thing)  # not budgeted

    def h_kv_put(self, conn, p):
        with self.lock:
            time.sleep(0.1)
        return True

    def h_wait_thing(self, conn, p):
        with self.lock:
            time.sleep(0.1)
        return True

    def h_clean(self, conn, p):
        with self.lock:
            x = 1
        time.sleep(0)       # not held: no finding
        return x
