"""Seconds from the process's start to the window's: imports, kernel builds
(or finding them built), the tokenizer, the weights, the stack, the
requests' payloads and the warm-up's captures (host clock)."""


def read(record):
    return record["setup_s"]
