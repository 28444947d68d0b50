"""Words shared by the review generators of several schemas."""

# latent sentiment -2..2 -> the two words a review may use for it
SENT_WORDS = {
    2: ("fantastic", "loved"), 1: ("good", "enjoyed"),
    0: ("okay", "fine"), -1: ("weak", "disliked"), -2: ("awful", "hated"),
}
