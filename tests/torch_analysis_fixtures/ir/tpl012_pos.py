# port lint fixture: TPL012 positive — a split of seven aten ops
# against a launch budget of six.
BUDGET = {"aten_ops_per_split": 6,
          "justification": "fixture: six launches a split"}


def split(hist):
    left = hist.cumsum(0)
    right = hist.sum(0) - left
    gain = left * left + right * right
    return gain.argmax()
