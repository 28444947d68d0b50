"""Synthetic benchmark schemas with latent ground truth (paper Table 1).

Five schemas — BookReview / Yelp / GoogleLocal (DataAgentBench-style),
TPC-H (SF≈0.005, 8 tables) and SemBench-style E-Commerce. Each generator
produces text columns *rendered from latent attributes*, so every semantic
predicate has an exact oracle: the truth functions read the latent fields
(prefixed ``_``) that relational predicates and prompts never reference
directly. This replaces the paper's human/GPT ground truth with a
deterministic one, letting benchmarks isolate placement effects from
backend noise (DESIGN.md §5).

Semantic predicate templates are module constants so the query corpus and
the truth registry stay in sync by construction.

Every generator takes the ``device`` its ``Database`` lives on
(``"cuda"`` by default; pass ``"cpu"`` to run on the CPU).
"""
from __future__ import annotations

import numpy as np

from ..engine.table import Database

# ---------------------------------------------------------------------------
# BookReview
# ---------------------------------------------------------------------------

BOOKS_ABOUT_AI = ("Is this book about artificial intelligence? "
                  "Description: {books.description}. Answer YES or NO.")
REVIEW_POSITIVE = ("Is this a positive review? Review: {reviews.text}. "
                   "Answer YES or NO.")
REVIEW_SENTIMENT = "Rate the sentiment of this review 1-5: {reviews.text}"
BOOK_SECOND_EDITION = ("Confirm this is the second edition of 'Make: "
                       "Electronics'. Title: {books.title} Subtitle: "
                       "{books.subtitle}. Answer YES or NO.")
REVIEW_MENTIONS_SHIPPING = ("Does this review complain about shipping or "
                            "packaging? {reviews.text}. Answer YES or NO.")
USER_IS_EXPERT = ("Does this bio describe a professional book critic? "
                  "Bio: {users.bio}. Answer YES or NO.")
REVIEW_MATCHES_BOOK = ("Does the review '{reviews.text}' plausibly discuss "
                       "the book titled '{books.title}'? Answer YES or NO.")

_TOPICS = ["artificial intelligence", "history", "cooking", "travel",
           "poetry", "finance", "biology", "music"]
_SENT_WORDS = {
    2: ("fantastic", "loved"), 1: ("good", "enjoyed"),
    0: ("okay", "fine"), -1: ("weak", "disliked"), -2: ("awful", "hated"),
}


def _mk_book(rng, i):
    topic = _TOPICS[rng.integers(len(_TOPICS))]
    second_ed = bool(rng.random() < 0.02)
    year = int(rng.integers(1990, 2024))
    title = f"Make: Electronics vol {i}" if second_ed else \
        f"The {topic.title()} Chronicle #{i}"
    return {
        "book_id": i,
        "title": title,
        "subtitle": "Second Edition" if second_ed else f"A study in {topic}",
        "author": f"Author {i % 97}",
        "categories": topic,
        "year": year,
        "description": (f"Volume {i}: an exploration of {topic} with case "
                        f"studies from {1990 + i % 30}."),
        "_topic": topic,
        "_second_edition": second_ed,
    }


def _mk_review(rng, i, n_books, noun="book"):
    # ~20% dangling FKs: the join eliminates these rows, so pulled-up
    # semantic filters skip them entirely (paper Fig. 1 premise)
    book = int(rng.integers(int(n_books * 1.25)))
    sent = int(rng.integers(-2, 3))  # latent sentiment −2..2
    rating = int(np.clip(sent + 3 + rng.integers(-1, 2), 1, 5))
    w = _SENT_WORDS[sent][rng.integers(2)]
    shipping = bool(rng.random() < 0.15)
    extra = (" The box arrived damaged and shipping took weeks."
             if shipping else "")
    return {
        "review_id": i,
        "book_id": book,
        "text": f"Honestly this {noun} was {w}, entry {i}.{extra}",
        "rating": rating,
        "helpful_vote": int(rng.integers(0, 120)),
        "verified_purchase": int(rng.random() < 0.7),
        "review_time": int(rng.integers(2015, 2020)),
        "_sentiment": sent,
        "_shipping_complaint": shipping,
    }


def make_bookreview(seed: int = 0, scale: float = 1.0,
                    device="cuda") -> Database:
    rng = np.random.default_rng(seed)
    n_books, n_reviews = int(400 * scale), int(1200 * scale)
    n_users = int(450 * scale)
    books = [_mk_book(rng, i) for i in range(n_books)]
    reviews = [_mk_review(rng, i, n_books) for i in range(n_reviews)]
    users = []
    for i in range(n_users):
        critic = bool(rng.random() < 0.1)
        users.append({
            "user_id": i,
            "bio": ("Professional literary critic reviewing for journals."
                    if critic else f"Casual reader number {i}."),
            "review_count": int(rng.integers(1, 400)),
            "_critic": critic,
        })
    db = Database(device=device)
    db.add_table("books", books, text_columns={"title", "subtitle", "author",
                                               "categories", "description"})
    db.add_table("reviews", reviews, text_columns={"text"})
    db.add_table("users", users, text_columns={"bio"})
    db.truths.update({
        BOOKS_ABOUT_AI:
            lambda c: c["books"]["_topic"] == "artificial intelligence",
        REVIEW_POSITIVE: lambda c: c["reviews"]["_sentiment"] > 0,
        REVIEW_SENTIMENT: lambda c: c["reviews"]["_sentiment"] + 3,
        BOOK_SECOND_EDITION: lambda c: c["books"]["_second_edition"],
        REVIEW_MENTIONS_SHIPPING:
            lambda c: c["reviews"]["_shipping_complaint"],
        USER_IS_EXPERT: lambda c: c["users"]["_critic"],
        REVIEW_MATCHES_BOOK: lambda c: (
            c["reviews"]["_sentiment"] != 0
            and c["reviews"]["book_id"] == c["books"]["book_id"]),
    })
    return db


# ---------------------------------------------------------------------------
# Yelp
# ---------------------------------------------------------------------------

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


def make_yelp(seed: int = 1, scale: float = 1.0,
              device="cuda") -> Database:
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
    db = Database(device=device)
    db.add_table("businesses", businesses,
                 text_columns={"name", "city", "category", "description"})
    db.add_table("yreviews", yreviews, text_columns={"text"})
    db.add_table("yusers", yusers, text_columns={"bio"})
    db.truths.update({
        BIZ_FAMILY_FRIENDLY: lambda c: c["businesses"]["_family"],
        BIZ_UPSCALE: lambda c: c["businesses"]["_upscale"],
        YELP_REVIEW_POSITIVE: lambda c: c["yreviews"]["_sentiment"] > 0,
        YELP_REVIEW_SERVICE: lambda c: c["yreviews"]["_service"],
        YELP_USER_LOCAL: lambda c: c["yusers"]["_local"],
        YELP_REVIEW_SCORE: lambda c: c["yreviews"]["_sentiment"] + 3,
    })
    return db


# ---------------------------------------------------------------------------
# GoogleLocal
# ---------------------------------------------------------------------------

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


def make_googlelocal(seed: int = 2, scale: float = 1.0,
                     device="cuda") -> Database:
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
    db = Database(device=device)
    db.add_table("places", places,
                 text_columns={"name", "category", "description"})
    db.add_table("greviews", greviews, text_columns={"text"})
    db.truths.update({
        PLACE_OUTDOOR: lambda c: c["places"]["_outdoor"],
        PLACE_ACCESSIBLE: lambda c: c["places"]["_accessible"],
        GL_REVIEW_POSITIVE: lambda c: c["greviews"]["_sentiment"] > 0,
        GL_REVIEW_PARKING: lambda c: c["greviews"]["_parking"],
        GL_REVIEW_DESCRIBES_PLACE: lambda c: (
            c["greviews"]["place_id"] == c["places"]["place_id"]),
        GL_REVIEW_PRAISES_PLACE: lambda c: (
            c["greviews"]["place_id"] == c["places"]["place_id"]
            and c["greviews"]["_sentiment"] > 0),
    })
    return db


# ---------------------------------------------------------------------------
# TPC-H (SF ≈ 0.005) with text-rich semantic columns (paper §6.1)
# ---------------------------------------------------------------------------

LINEITEM_PROBLEM = ("Mode: {lineitem.l_shipmode} Instruction: "
                    "{lineitem.l_shipinstruct}. Is this a potentially "
                    "problematic fulfillment case? Answer YES or NO.")
CUSTOMER_RISK = ("Segment: {customer.c_mktsegment} Balance: "
                 "{customer.c_acctbal}. Higher complaint/escalation risk? "
                 "Answer YES or NO.")
PART_FRAGILE = ("Part: {part.p_comment}. Does the comment indicate a "
                "fragile item? Answer YES or NO.")
SUPPLIER_RELIABLE = ("Supplier note: {supplier.s_comment}. Does it suggest "
                     "reliable delivery? Answer YES or NO.")
ORDER_URGENT_TONE = ("Order note: {orders.o_comment}. Does the note sound "
                     "urgent? Answer YES or NO.")
NATION_MATCHES_SUPPLIER = ("Is supplier comment '{supplier.s_comment}' "
                           "consistent with operations in "
                           "'{nation.n_name}'? Answer YES or NO.")

_SHIPMODES = ["AIR", "RAIL", "TRUCK", "SHIP", "MAIL"]
_INSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
_SEGMENTS = ["BUILDING", "AUTOMOBILE", "MACHINERY", "HOUSEHOLD", "FURNITURE"]


def make_tpch(seed: int = 3, scale: float = 1.0,
              device="cuda") -> Database:
    rng = np.random.default_rng(seed)
    n_region, n_nation, n_supp = 5, 25, int(40 * scale)
    n_cust, n_part = int(450 * scale), int(600 * scale)
    n_psupp, n_orders = int(2400 * scale), int(3000 * scale)
    n_line = int(12000 * scale)

    region = [{"r_regionkey": i, "r_name": f"REGION{i}"}
              for i in range(n_region)]
    nation = [{"n_nationkey": i, "n_name": f"NATION{i}",
               "n_regionkey": i % n_region} for i in range(n_nation)]
    supplier = []
    for i in range(n_supp):
        reliable = bool(rng.random() < 0.5)
        supplier.append({
            "s_suppkey": i, "s_nationkey": int(rng.integers(n_nation)),
            "s_comment": (f"supplier {i} ships on schedule every week"
                          if reliable else f"supplier {i} has delayed lots"),
            "_reliable": reliable,
        })
    customer = []
    for i in range(n_cust):
        seg = _SEGMENTS[int(rng.integers(len(_SEGMENTS)))]
        bal = float(np.round(rng.uniform(-999, 9999), 2))
        risk = seg in ("AUTOMOBILE", "MACHINERY") and bal < 1000
        customer.append({
            "c_custkey": i, "c_nationkey": int(rng.integers(n_nation)),
            "c_mktsegment": seg, "c_acctbal": bal, "_risk": bool(risk),
        })
    part = []
    for i in range(n_part):
        fragile = bool(rng.random() < 0.25)
        part.append({
            "p_partkey": i, "p_size": int(rng.integers(1, 51)),
            "p_retailprice": float(np.round(rng.uniform(900, 2000), 2)),
            "p_comment": ("handle with care glass contents" if fragile
                          else f"standard packaging lot {i}"),
            "_fragile": fragile,
        })
    partsupp = []
    for i in range(n_psupp):
        partsupp.append({
            "ps_partkey": int(rng.integers(n_part)),
            "ps_suppkey": int(rng.integers(n_supp)),
            "ps_availqty": int(rng.integers(1, 1000)),
            "ps_supplycost": float(np.round(rng.uniform(1, 1000), 2)),
        })
    orders = []
    for i in range(n_orders):
        urgent = bool(rng.random() < 0.2)
        orders.append({
            "o_orderkey": i,
            "o_custkey": int(rng.integers(int(n_cust * 1.15))),
            "o_orderstatus": ["O", "F", "P"][int(rng.integers(3))],
            "o_totalprice": float(np.round(rng.uniform(1000, 300000), 2)),
            "o_orderdate": int(rng.integers(1992, 1999)),
            "o_comment": (f"order {i} requested expedited rush handling"
                          if urgent else f"order {i} routine processing"),
            "_urgent": urgent,
        })
    lineitem = []
    for i in range(n_line):
        mode = _SHIPMODES[int(rng.integers(len(_SHIPMODES)))]
        instr = _INSTRUCT[int(rng.integers(len(_INSTRUCT)))]
        problem = (mode in ("AIR", "MAIL") and instr in
                   ("COLLECT COD", "TAKE BACK RETURN"))
        lineitem.append({
            "l_orderkey": int(rng.integers(int(n_orders * 1.2))),
            "l_partkey": int(rng.integers(int(n_part * 1.2))),
            "l_suppkey": int(rng.integers(n_supp)),
            "l_linenumber": i,
            "l_quantity": int(rng.integers(1, 51)),
            "l_extendedprice": float(np.round(rng.uniform(1000, 100000), 2)),
            "l_returnflag": ["R", "A", "N"][int(rng.integers(3))],
            "l_shipdate": int(rng.integers(1992, 1999)),
            "l_shipmode": mode, "l_shipinstruct": instr,
            "_problem": bool(problem),
        })
    db = Database(device=device)
    db.add_table("region", region, text_columns={"r_name"})
    db.add_table("nation", nation, text_columns={"n_name"})
    db.add_table("supplier", supplier, text_columns={"s_comment"})
    db.add_table("customer", customer, text_columns={"c_mktsegment"})
    db.add_table("part", part, text_columns={"p_comment"})
    db.add_table("partsupp", partsupp)
    db.add_table("orders", orders, text_columns={"o_orderstatus", "o_comment"})
    db.add_table("lineitem", lineitem,
                 text_columns={"l_returnflag", "l_shipmode", "l_shipinstruct"})
    db.truths.update({
        LINEITEM_PROBLEM: lambda c: c["lineitem"]["_problem"],
        CUSTOMER_RISK: lambda c: c["customer"]["_risk"],
        PART_FRAGILE: lambda c: c["part"]["_fragile"],
        SUPPLIER_RELIABLE: lambda c: c["supplier"]["_reliable"],
        ORDER_URGENT_TONE: lambda c: c["orders"]["_urgent"],
        NATION_MATCHES_SUPPLIER: lambda c: (
            c["supplier"]["_reliable"]
            and c["supplier"]["s_nationkey"] == c["nation"]["n_nationkey"]),
    })
    return db


# ---------------------------------------------------------------------------
# SemBench-style E-Commerce (14 simple queries, human-annotated analogue)
# ---------------------------------------------------------------------------

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


def make_ecommerce(seed: int = 4, scale: float = 1.0,
                   device="cuda") -> Database:
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
    db = Database(device=device)
    db.add_table("products", products,
                 text_columns={"title", "category", "brand", "description"})
    db.add_table("previews", previews, text_columns={"text"})
    db.truths.update({
        PRODUCT_IS_ELECTRONICS:
            lambda c: c["products"]["_cat"] == "electronics",
        PRODUCT_ECO: lambda c: c["products"]["_eco"],
        PRODUCT_FOR_KIDS: lambda c: c["products"]["_kids"],
        ECOM_REVIEW_POSITIVE: lambda c: c["previews"]["_sentiment"] > 0,
        ECOM_REVIEW_DEFECT: lambda c: c["previews"]["_defect"],
        PRODUCT_QUALITY_SCORE: lambda c: c["products"]["_quality"],
    })
    return db


SCHEMAS = {
    "bookreview": make_bookreview,
    "yelp": make_yelp,
    "googlelocal": make_googlelocal,
    "tpch": make_tpch,
    "ecommerce": make_ecommerce,
}
