"""GoogleLocal (DataAgentBench-style): places, greviews.

A frozen copy of the generator in the port's ``data/schemas.py``: the
benchmark makes its tables itself and hands the same records to the
program and to the reference. ``make(seed, scale)`` returns
``{table: (records, text columns)}``; ``TEMPLATES`` names the
semantic predicates the query files refer to."""
import numpy as np

from ._common import SENT_WORDS as _SENT_WORDS


PLACE_OUTDOOR = ("Does this place offer outdoor seating? Description: "
                 "{places.description}. Answer YES or NO.")
PLACE_ACCESSIBLE = ("Is this place wheelchair accessible per the "
                    "description? {places.description}. Answer YES or NO.")
GL_REVIEW_POSITIVE = ("Is this review positive? {greviews.text}. "
                      "Answer YES or NO.")
GL_REVIEW_PARKING = ("Does the review mention parking problems? "
                     "{greviews.text}. Answer YES or NO.")
GL_REVIEW_DESCRIBES_PLACE = ("Would review '{greviews.text}' plausibly "
                             "describe place {places.place_id}? "
                             "Answer YES or NO.")
GL_REVIEW_PRAISES_PLACE = ("Does '{greviews.text}' praise venue "
                           "{places.place_id}? Answer YES or NO.")


def make(seed: int, scale: float) -> dict:
    rng = np.random.default_rng(seed)
    n_places, n_rev = int(700 * scale), int(1400 * scale)
    places = []
    for i in range(n_places):
        outdoor = bool(rng.random() < 0.35)
        access = bool(rng.random() < 0.5)
        places.append({
            "place_id": i, "name": f"Place {i}",
            "category": ["cafe", "museum", "park",
                         "store"][int(rng.integers(4))],
            "rating": float(np.round(rng.uniform(1, 5), 1)),
            "description": (f"Venue {i}."
                            + (" Lovely patio with outdoor tables."
                               if outdoor else "")
                            + (" Step-free entrance and ramps."
                               if access else "")),
            "_outdoor": outdoor, "_accessible": access,
        })
    greviews = []
    for i in range(n_rev):
        sent = int(rng.integers(-2, 3))
        parking = bool(rng.random() < 0.2)
        w = _SENT_WORDS[sent][rng.integers(2)]
        greviews.append({
            "review_id": i, "place_id": int(rng.integers(n_places)),
            "text": (f"Visit {i} was {w}."
                     + (" Could not find parking anywhere."
                        if parking else "")),
            "rating": int(np.clip(sent + 3, 1, 5)),
            "time": int(rng.integers(2018, 2024)),
            "_sentiment": sent, "_parking": parking,
        })
    tables = {}
    tables["places"] = (places, {"name", "category", "description"})
    tables["greviews"] = (greviews, {"text"})
    return tables


TEMPLATES = {
    "PLACE_OUTDOOR": PLACE_OUTDOOR,
    "PLACE_ACCESSIBLE": PLACE_ACCESSIBLE,
    "GL_REVIEW_POSITIVE": GL_REVIEW_POSITIVE,
    "GL_REVIEW_PARKING": GL_REVIEW_PARKING,
    "GL_REVIEW_DESCRIBES_PLACE": GL_REVIEW_DESCRIBES_PLACE,
    "GL_REVIEW_PRAISES_PLACE": GL_REVIEW_PRAISES_PLACE,
}
