# port lint fixture: TPL011 positive — a float64 aten op in an entry
# that declares none.
DECLARED = []


def entry(x):
    # EXPECT: TPL011
    return (x.double() * 2).float()
