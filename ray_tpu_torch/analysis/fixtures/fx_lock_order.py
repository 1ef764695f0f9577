"""Seeded violations for the lock_order pass (parsed, never imported).

Expected findings:
- lock-order-cycle   Widget.a <-> Widget.b  (one() nests a->b, two()
                     reaches b->a through helper())
- lock-held-blocking time.sleep and sock.recv under Widget.a in blocky()
- lock-held-blocking call to slow_io (which blocks) under Widget.a
- lock-self-reacquire Widget.a in reenter()
"""

import socket
import threading
import time


def slow_io(sock):
    return sock.recv(4096)


class Widget:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()

    def one(self):
        with self.a:
            with self.b:
                return 1

    def two(self):
        with self.b:
            self.helper()

    def helper(self):
        with self.a:
            return 2

    def blocky(self, sock: socket.socket):
        with self.a:
            time.sleep(0.1)
            sock.recv(1024)

    def via_callee(self, sock):
        with self.a:
            slow_io(sock)

    def reenter(self):
        with self.a:
            with self.a:
                return 3

    def clean(self):
        with self.a:
            x = 1
        time.sleep(0)       # not held: no finding
        return x
