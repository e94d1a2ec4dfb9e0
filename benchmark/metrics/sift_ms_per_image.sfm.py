"""SIFT's host-clock time an image: spans around each
``sift_detect_and_compute`` call, the device synchronized at both ends."""


def read(obs: dict):
    s = obs["spans"].get("sift")
    if not s:
        return None
    return 1000.0 * sum(t for t, _ in s) / sum(n for _, n in s)
