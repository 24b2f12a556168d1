"""Seconds the entry layer took to make the witness (the trace, or the
VM's run and the tables' upload), host clock, ending in a synchronise."""


def read(r):
    return r.entry_s
