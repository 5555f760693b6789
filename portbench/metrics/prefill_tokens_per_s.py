"""prefill_tokens_per_s [tokens/s]: all prompt tokens prefilled in
the window over the window's time."""


def read(record):
    if record.get("driver") != "prefill":
        return None
    return record["tokens"] / record["window_s"]
