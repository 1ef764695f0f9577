"""Per-node worker-log tailer -> control pubsub -> driver stderr.

The reference tails each worker's log files in a per-node log_monitor
process and publishes new lines to the driver through GCS pubsub
(reference: python/ray/_private/log_monitor.py) — that is how ``print``
inside a task reaches the driver console.  Here the tailer is a thread
inside the raylet: it follows ``logs/worker-*.log``, attributes lines to
jobs via inline job markers the workers emit (workers are shared across
jobs, unlike the reference's per-job workers), and publishes batches on
the ``worker_logs`` topic.  Driver cores subscribe and echo lines for
their job (``ray_tpu_torch.init(log_to_driver=...)``).

The port's copy of ``ray_tpu/_private/log_monitor.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import glob
import logging
import os
import threading
from typing import Dict, Optional

logger = logging.getLogger(__name__)

# Workers print this marker (alone on a line) when they start executing
# work for a different job; lines that follow belong to that job.
JOB_MARKER = "\x01RAYTPU-JOB "

from .config import cfg as _cfg

POLL_INTERVAL_S = 0.25
MAX_BATCH_LINES = _cfg().log_to_driver_batch_lines
MAX_LINE_LEN = 4000


class _FileState:
    __slots__ = ("offset", "job_id", "partial")

    def __init__(self):
        self.offset = 0
        self.job_id = ""      # last job marker seen in this file
        self.partial = b""    # trailing bytes with no newline yet


class LogMonitor:
    """Tails worker logs under `log_dir` and publishes new lines via
    `publish(payload)` (a callable hitting the control pubsub)."""

    def __init__(self, log_dir: str, node_id: str, publish):
        self.log_dir = log_dir
        self.node_id = node_id
        self.publish = publish
        self._files: Dict[str, _FileState] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._loop,
                                        name="raylet-log-monitor",
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(POLL_INTERVAL_S):
            try:
                self.poll_once()
            except Exception:
                logger.exception("log monitor poll failed")

    def poll_once(self):
        for path in glob.glob(os.path.join(self.log_dir, "worker-*.log")):
            st = self._files.get(path)
            if st is None:
                st = self._files[path] = _FileState()
            try:
                size = os.path.getsize(path)
                if size <= st.offset:
                    continue
                with open(path, "rb") as f:
                    f.seek(st.offset)
                    data = f.read(1 << 20)
                    st.offset = f.tell()
            except OSError:
                continue
            self._emit(path, st, st.partial + data)

    def _emit(self, path: str, st: _FileState, data: bytes):
        worker = os.path.basename(path)[len("worker-"):-len(".log")]
        lines = data.split(b"\n")
        st.partial = lines.pop()  # tail w/o newline waits for more bytes
        batch = []

        def flush():
            if batch:
                self.publish({"node_id": self.node_id, "worker_id": worker,
                              "job_id": st.job_id, "lines": list(batch)})
                batch.clear()

        for raw in lines:
            line = raw[:MAX_LINE_LEN].decode("utf-8", errors="replace")
            if line.startswith(JOB_MARKER):
                flush()  # lines before the marker belong to the old job
                st.job_id = line[len(JOB_MARKER):].strip()
                continue
            batch.append(line)
            if len(batch) >= MAX_BATCH_LINES:
                flush()
        flush()
