"""SemBench-style E-Commerce: products, previews.

A frozen copy of the generator in the port's ``data/schemas.py``: the
benchmark makes its tables itself and hands the same records to the
program and to the reference. ``make(seed, scale)`` returns
``{table: (records, text columns)}``; ``TEMPLATES`` names the
semantic predicates the query files refer to."""
import numpy as np

from ._common import SENT_WORDS as _SENT_WORDS


PRODUCT_IS_ELECTRONICS = ("Is this product an electronics item? "
                          "{products.description}. Answer YES or NO.")
PRODUCT_ECO = ("Is this product marketed as eco-friendly? "
               "{products.description}. Answer YES or NO.")
PRODUCT_FOR_KIDS = ("Is this product suitable for children? "
                    "{products.description}. Answer YES or NO.")
ECOM_REVIEW_POSITIVE = ("Is this product review positive? {previews.text}. "
                        "Answer YES or NO.")
ECOM_REVIEW_DEFECT = ("Does the review report a defect? {previews.text}. "
                      "Answer YES or NO.")
PRODUCT_QUALITY_SCORE = "Score build quality 1-5: {products.description}"

_PCATS = ["electronics", "toys", "kitchen", "garden", "clothing"]


def make(seed: int, scale: float) -> dict:
    rng = np.random.default_rng(seed)
    n_prod, n_rev = int(600 * scale), int(1800 * scale)
    products = []
    for i in range(n_prod):
        cat = _PCATS[int(rng.integers(len(_PCATS)))]
        eco = bool(rng.random() < 0.2)
        kids = cat == "toys" or bool(rng.random() < 0.1)
        quality = int(rng.integers(1, 6))
        products.append({
            "product_id": i, "title": f"Product {i}", "category": cat,
            "price": float(np.round(rng.uniform(5, 500), 2)),
            "brand": f"brand{i % 40}",
            "description": (f"A {cat} item, model {i}, build grade {quality}."
                            + (" Made from recycled materials." if eco else "")
                            + (" Safe for ages 3 and up." if kids else "")),
            "_cat": cat, "_eco": eco, "_kids": kids, "_quality": quality,
        })
    previews = []
    for i in range(n_rev):
        sent = int(rng.integers(-2, 3))
        defect = bool(rng.random() < 0.15)
        w = _SENT_WORDS[sent][rng.integers(2)]
        previews.append({
            "review_id": i, "product_id": int(rng.integers(int(n_prod * 1.2))),
            "text": (f"Purchase {i} felt {w}."
                     + (" It broke after two days, clearly defective."
                        if defect else "")),
            "rating": int(np.clip(sent + 3, 1, 5)),
            "_sentiment": sent, "_defect": defect,
        })
    tables = {}
    tables["products"] = (
        products, {"title", "category", "brand", "description"})
    tables["previews"] = (previews, {"text"})
    return tables


TEMPLATES = {
    "PRODUCT_IS_ELECTRONICS": PRODUCT_IS_ELECTRONICS,
    "PRODUCT_ECO": PRODUCT_ECO,
    "PRODUCT_FOR_KIDS": PRODUCT_FOR_KIDS,
    "ECOM_REVIEW_POSITIVE": ECOM_REVIEW_POSITIVE,
    "ECOM_REVIEW_DEFECT": ECOM_REVIEW_DEFECT,
    "PRODUCT_QUALITY_SCORE": PRODUCT_QUALITY_SCORE,
}
