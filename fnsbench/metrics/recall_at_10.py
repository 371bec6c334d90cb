"""Mean recall@10 against the exact filtered top-10 over every request of
the window."""


def read(rec):
    return None if rec.k != 10 else rec.recall
