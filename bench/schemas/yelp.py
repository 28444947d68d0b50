"""Yelp (DataAgentBench-style): businesses, yreviews, yusers.

A frozen copy of the generator in the port's ``data/schemas.py``: the
benchmark makes its tables itself and hands the same records to the
program and to the reference. ``make(seed, scale)`` returns
``{table: (records, text columns)}``; ``TEMPLATES`` names the
semantic predicates the query files refer to."""
import numpy as np

from ._common import SENT_WORDS as _SENT_WORDS


BIZ_FAMILY_FRIENDLY = ("Is this business family friendly? Description: "
                       "{businesses.description}. Answer YES or NO.")
BIZ_UPSCALE = ("Does this description indicate an upscale venue? "
               "{businesses.description}. Answer YES or NO.")
YELP_REVIEW_POSITIVE = ("Is this Yelp review positive? {yreviews.text}. "
                        "Answer YES or NO.")
YELP_REVIEW_SERVICE = ("Does this review praise the customer service? "
                       "{yreviews.text}. Answer YES or NO.")
YELP_USER_LOCAL = ("Does this user bio suggest a local resident? "
                   "{yusers.bio}. Answer YES or NO.")
YELP_REVIEW_SCORE = "Rate food quality 1-5 from this review: {yreviews.text}"

_CUISINES = ["mexican", "italian", "sushi", "bbq", "vegan", "diner", "thai"]


def make(seed: int, scale: float) -> dict:
    rng = np.random.default_rng(seed)
    n_biz, n_rev = int(800 * scale), int(3200 * scale)
    n_users = int(800 * scale)
    businesses = []
    for i in range(n_biz):
        fam = bool(rng.random() < 0.3)
        upscale = bool(rng.random() < 0.2)
        cuisine = _CUISINES[rng.integers(len(_CUISINES))]
        desc = (f"{cuisine.title()} spot #{i}."
                + (" Kids menu and playground available." if fam else "")
                + (" White-tablecloth fine dining experience."
                   if upscale else ""))
        businesses.append({
            "biz_id": i, "name": f"Biz {i}", "city": f"city{i % 12}",
            "stars": float(np.round(rng.uniform(1, 5), 1)),
            "category": cuisine, "description": desc,
            "_family": fam, "_upscale": upscale,
        })
    yreviews = []
    for i in range(n_rev):
        biz = int(rng.integers(int(n_biz * 1.25)))
        sent = int(rng.integers(-2, 3))
        service = bool(rng.random() < 0.25)
        w = _SENT_WORDS[sent][rng.integers(2)]
        yreviews.append({
            "review_id": i, "biz_id": biz,
            "user_id": int(rng.integers(n_users)),
            "text": (f"The food was {w}, visit {i}."
                     + (" Staff went above and beyond!" if service else "")),
            "stars": int(np.clip(sent + 3, 1, 5)),
            "useful": int(rng.integers(0, 50)),
            "_sentiment": sent, "_service": service,
        })
    yusers = []
    for i in range(n_users):
        local = bool(rng.random() < 0.4)
        yusers.append({
            "user_id": i,
            "bio": (f"Born and raised here, resident {i}." if local
                    else f"Travelling foodie {i}."),
            "review_count": int(rng.integers(1, 300)),
            "_local": local,
        })
    tables = {}
    tables["businesses"] = (
        businesses, {"name", "city", "category", "description"})
    tables["yreviews"] = (yreviews, {"text"})
    tables["yusers"] = (yusers, {"bio"})
    return tables


TEMPLATES = {
    "BIZ_FAMILY_FRIENDLY": BIZ_FAMILY_FRIENDLY,
    "BIZ_UPSCALE": BIZ_UPSCALE,
    "YELP_REVIEW_POSITIVE": YELP_REVIEW_POSITIVE,
    "YELP_REVIEW_SERVICE": YELP_REVIEW_SERVICE,
    "YELP_USER_LOCAL": YELP_USER_LOCAL,
    "YELP_REVIEW_SCORE": YELP_REVIEW_SCORE,
}
