"""BookReview (DataAgentBench-style): books, reviews, users.

A frozen copy of the generator in the port's ``data/schemas.py``: the
benchmark makes its tables itself and hands the same records to the
program and to the reference. ``make(seed, scale)`` returns
``{table: (records, text columns)}``; ``TEMPLATES`` names the
semantic predicates the query files refer to."""
import numpy as np

from ._common import SENT_WORDS as _SENT_WORDS


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


def make(seed: int, scale: float) -> dict:
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
    tables = {}
    tables["books"] = (
        books, {"title", "subtitle", "author",
                                               "categories", "description"})
    tables["reviews"] = (reviews, {"text"})
    tables["users"] = (users, {"bio"})
    return tables


TEMPLATES = {
    "BOOKS_ABOUT_AI": BOOKS_ABOUT_AI,
    "REVIEW_POSITIVE": REVIEW_POSITIVE,
    "REVIEW_SENTIMENT": REVIEW_SENTIMENT,
    "BOOK_SECOND_EDITION": BOOK_SECOND_EDITION,
    "REVIEW_MENTIONS_SHIPPING": REVIEW_MENTIONS_SHIPPING,
    "USER_IS_EXPERT": USER_IS_EXPERT,
    "REVIEW_MATCHES_BOOK": REVIEW_MATCHES_BOOK,
}
