"""``wowbench.reference`` against a brute force written out here, and the
per-reply rules and limits of ``judge`` on hand-made replies (CPU)."""
import numpy as np
import pytest

from wowbench import reference
from wowbench import data


def _brute(vecs, attrs, q, rng, k):
    """Exact range-filtered k-NN of one query, one row at a time."""
    cand = []
    for i in range(len(vecs)):
        if rng[0] <= attrs[i] <= rng[1]:
            diff = vecs[i].astype(np.float64) - q.astype(np.float64)
            cand.append((float(diff @ diff), i))
    cand.sort()
    return [i for _, i in cand[:k]], [d for d, _ in cand[:k]]


@pytest.fixture(scope="module")
def tiny():
    base = data.make_base(300, 8, 5, "cpu")
    q = data.make_queries(base, 40, data.mixed_fractions(-6, 0),
                          data.generator(5, "cpu"))
    return (base.vectors.numpy(), base.attrs.numpy(), q.vectors.numpy(),
            q.ranges.numpy())


def test_exact_knn_matches_brute_force(tiny):
    vecs, attrs, qs, rs = tiny
    ids, dists = reference.exact_knn(vecs, attrs, qs, rs, 10, block=7)
    for j in range(len(qs)):
        want_i, want_d = _brute(vecs, attrs, qs[j], rs[j], 10)
        got = ids[j][ids[j] >= 0]
        assert list(got) == want_i
        np.testing.assert_allclose(dists[j][: len(want_d)], want_d,
                                   rtol=1e-9, atol=1e-9)
        assert (ids[j][len(want_i):] == -1).all()


def test_pair_dists_are_exact(tiny):
    vecs, attrs, qs, _ = tiny
    qidx = np.arange(len(qs)) % len(qs)
    ids = np.stack([np.arange(10) + j for j in range(len(qs))])
    ids[0, 3] = -1
    d, scale = reference.pair_dists(vecs, qs, qidx, ids, block=9)
    v, q = vecs.astype(np.float64), qs.astype(np.float64)
    for j in range(len(qs)):
        for s in range(10):
            if ids[j, s] < 0:
                assert d[j, s] == np.inf and scale[j, s] == 1.0
                continue
            diff = v[ids[j, s]] - q[j]
            assert d[j, s] == pytest.approx(diff @ diff, rel=1e-12)
            assert scale[j, s] == pytest.approx(
                v[ids[j, s]] @ v[ids[j, s]] + q[j] @ q[j], rel=1e-12)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = np.array([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                  1.0 + 2**-12, -3.14159265], np.float32)
    got = reference.tf32(x)
    # ties go to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9
    want = np.array([1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0,
                     -3.140625], np.float32)
    np.testing.assert_array_equal(got, want)
    bits = got.view(np.uint32)
    assert (bits & 0x1FFF == 0).all()


def test_judge_accepts_the_exact_answers(tiny):
    vecs, attrs, qs, rs = tiny
    ids, dists = reference.exact_knn(vecs, attrs, qs, rs, 10)
    qidx = np.arange(len(qs))
    v = reference.judge(vecs, attrs, qs, rs, qidx, ids,
                        dists.astype(np.float32), k=10,
                        limits={"recall_min": 0.9, "dist_gap_max": 1e-5})
    assert v["correct"] and v["recall"] == 1.0
    assert v["checks"]["dist_gap"][0] < 1e-6


@pytest.mark.parametrize("fault", ["outside_range", "repeat", "unsorted",
                                   "wrong_distance", "empty", "unanswered",
                                   "no_replies"])
def test_judge_rejects_a_faulty_reply(tiny, fault):
    vecs, attrs, qs, rs = tiny
    ids, dists = reference.exact_knn(vecs, attrs, qs, rs, 10)
    ids, dists = ids.copy(), dists.astype(np.float32)
    j = int(np.argmax((ids >= 0).sum(1)))  # a query with ten answers
    unanswered = 0
    if fault == "outside_range":
        outside = np.flatnonzero((attrs < rs[j, 0]) | (attrs > rs[j, 1]))
        ids[j, 0] = outside[0]
    elif fault == "repeat":
        ids[j, 1], dists[j, 1] = ids[j, 0], dists[j, 0]
    elif fault == "unsorted":
        dists[j, 0] = dists[j, 5] * 1.5
    elif fault == "wrong_distance":
        dists[j, 0] *= np.float32(1.001)
    elif fault == "empty":
        ids[:] = -1
        dists[:] = np.inf
    elif fault == "no_replies":  # every request unanswered
        unanswered = len(qs)
        ids, dists = ids[:0], dists[:0]
    else:
        unanswered = 1
    qidx = np.arange(len(ids))
    v = reference.judge(vecs, attrs, qs, rs, qidx, ids, dists,
                        k=10, unanswered=unanswered,
                        limits={"recall_min": 0.9, "dist_gap_max": 1e-5})
    assert not v["correct"], v["checks"]


def test_judge_takes_recall_over_the_marked_replies(tiny):
    vecs, attrs, qs, rs = tiny
    ids, dists = reference.exact_knn(vecs, attrs, qs, rs, 10)
    ids, dists = ids.copy(), dists.astype(np.float32)
    j = int(np.argmax((ids >= 0).sum(1)))
    ids[j, 0], dists[j, 0] = -1, np.inf  # one answer short...
    ids[j] = np.roll(ids[j], -1)
    dists[j] = np.roll(dists[j], -1)
    mask = np.ones(len(qs), bool)
    mask[j] = False  # ... in a reply whose recall is not taken
    lim = {"recall_min": 0.9, "dist_gap_max": 1e-5}
    v = reference.judge(vecs, attrs, qs, rs, np.arange(len(qs)), ids, dists,
                        k=10, limits=lim, recall_mask=mask)
    assert v["recall"] == 1.0
    full = reference.judge(vecs, attrs, qs, rs, np.arange(len(qs)), ids,
                           dists, k=10, limits=lim)
    assert full["recall"] == pytest.approx(1.0 - 0.1 / len(qs))
    # a per-reply rule holds every reply, marked or not
    ids[j, 0] = ids[j, 1]
    v = reference.judge(vecs, attrs, qs, rs, np.arange(len(qs)), ids, dists,
                        k=10, limits=lim, recall_mask=mask)
    assert v["checks"]["bad_replies"][0] == 1 and not v["correct"]
