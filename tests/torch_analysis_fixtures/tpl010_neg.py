# port lint fixture: TPL010 negative — read-backs a collective made
# uniform, and a justified pragma.
def uniform(flag, comm, t):
    comm.all_reduce(flag, "max")
    if flag.item():
        comm.all_reduce(t)


def uniform_inline(flag, comm, t):
    if comm.all_reduce(flag).item():
        comm.all_reduce(t)


def justified(flag, comm, t):
    # tpulint: replicated-cond flag is a function of the reduced histogram
    if flag.item():
        comm.all_reduce(t)
