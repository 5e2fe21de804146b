# port lint fixture: TPL008 negative — the same recorder with its lock.
import threading

_events = []
_events_lock = threading.Lock()


class Recorder:
    def __init__(self):
        self._lock = threading.Lock()
        self.pending = []
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        while True:
            with self._lock:
                self.pending.clear()

    def snapshot(self):
        with self._lock:
            return list(self.pending)


def _worker():
    with _events_lock:
        _events.append({"event": "compile"})


def start():
    threading.Thread(target=_worker).start()
    with _events_lock:
        return list(_events)
