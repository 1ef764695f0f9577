"""Seeded violations for the blocking_async pass (parsed, never imported).

Expected findings:
- blocking-in-async  time.sleep in bad_sleep()
- blocking-in-async  sock.recv in bad_recv()

Non-findings: awaited asyncio.sleep, the nested sync def, # async-ok.
"""

import asyncio
import time


async def bad_sleep():
    time.sleep(0.1)


async def bad_recv(sock):
    return sock.recv(10)


async def good():
    await asyncio.sleep(0)

    def inner():
        time.sleep(0.1)     # sync nested def: runs off-loop

    time.sleep(0)           # async-ok
    return inner
