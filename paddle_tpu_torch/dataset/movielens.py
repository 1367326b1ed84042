"""MovieLens stand-in (reference: python/paddle/v2/dataset/movielens.py,
samples of (user, gender, age, job, movie, category ids, title ids,
score)).

Counterpart of paddle_tpu/dataset/movielens.py: the same synthetic
samples from `common.rng(seed)` (943 users, 1,682 movies, 20 jobs, 18
categories, a 1,512-word title vocabulary), so it gives the JAX
package's samples.
"""

from .common import rng

__all__ = ["train", "test", "max_user_id", "max_movie_id", "max_job_id",
           "age_table", "movie_categories"]

_USERS = 943
_MOVIES = 1682
_JOBS = 20
_CATS = 18
_TITLE_VOCAB = 1512
age_table = [1, 18, 25, 35, 45, 50, 56]


def max_user_id():
    return _USERS


def max_movie_id():
    return _MOVIES


def max_job_id():
    return _JOBS


def movie_categories():
    return {("cat%d" % i): i for i in range(_CATS)}


def _reader(n, seed):
    r = rng(seed)

    def reader():
        for _ in range(n):
            uid = int(r.randint(1, _USERS + 1))
            gender = int(r.randint(0, 2))
            age = int(r.randint(0, len(age_table)))
            job = int(r.randint(0, _JOBS))
            mid = int(r.randint(1, _MOVIES + 1))
            cats = r.randint(0, _CATS,
                             size=int(r.randint(1, 4))).tolist()
            title = r.randint(0, _TITLE_VOCAB,
                              size=int(r.randint(2, 8))).tolist()
            # score correlates with (uid+mid) parity-ish signal
            score = float(((uid * 7 + mid * 13) % 50) / 10.0)
            yield uid, gender, age, job, mid, cats, title, score

    return reader


def train():
    return _reader(4096, 21)


def test():
    return _reader(512, 22)
