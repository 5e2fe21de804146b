# port lint fixture: TPL008 positive — a drain thread mutating fields no
# lock guards.
import threading

_events = []


class Recorder:
    def __init__(self):
        self.pending = []
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        while True:
            # EXPECT: TPL008
            self.pending.clear()

    def snapshot(self):
        return list(self.pending)


def _worker():
    # EXPECT: TPL008
    _events.append({"event": "compile"})


def start():
    threading.Thread(target=_worker).start()
    return list(_events)
