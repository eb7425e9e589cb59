"""egress_words_per_s: words of every completed fabric step (checked and
decrypted, or denied) over the window, on the host clock."""


def read(record):
    return record.counters["words"] / record.window_s
