"""The evaluation's own time per batch: from a batch's hand-out to the
request of the next, minus the attack span (which ends in a
synchronise), so the host-to-device copy, the metric pass, the two
judging forwards and the host read (host clock)."""


def read(run):
    bs = [b for b in run.batches
          if b.batch_s is not None and b.attack_s is not None]
    if not bs:
        return None
    return 1e3 * sum(b.batch_s - b.attack_s for b in bs) / len(bs)
