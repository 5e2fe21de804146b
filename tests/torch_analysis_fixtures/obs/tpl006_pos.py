# port lint fixture: TPL006 positive — device work under a telemetry
# lock.
import threading

import torch


class Recorder:
    def __init__(self):
        self._lock = threading.Lock()
        self.last = None

    def record(self, t):
        with self._lock:
            # EXPECT: TPL006
            self.last = t.to("cpu")

    def zero(self):
        with self._lock:
            # EXPECT: TPL006
            self.last = torch.zeros(4, device="cuda")
