# port lint fixture: TPL006 negative — copy outside the lock, store
# under it.
import threading


class Recorder:
    def __init__(self):
        self._lock = threading.Lock()
        self.last = None

    def record(self, t):
        host = t.to("cpu")
        with self._lock:
            self.last = host
