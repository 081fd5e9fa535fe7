"""recall_at_10: mean recall@10 against the reference's exact range-
filtered 10-NN: of every reply of the window in a read mix, of the probe
sent after the window in an ingest mix."""


def read(r):
    return r.recall
