# port lint fixture: TPL011 negative — float32 work, and a float64 op in
# a function the entry declares.
DECLARED = ["ir/tpl011_neg.py:_exact_sum"]


def _exact_sum(x):
    return x.double().sum().float()


def entry(x):
    return x * 2 + _exact_sum(x)
