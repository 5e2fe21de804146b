# port lint fixture: TPL012 negative — the same split within its budget
# of seven (cumsum, sum, sub, two muls, add, argmax).
BUDGET = {"aten_ops_per_split": 7,
          "justification": "fixture: seven launches a split"}


def split(hist):
    left = hist.cumsum(0)
    right = hist.sum(0) - left
    gain = left * left + right * right
    return gain.argmax()
