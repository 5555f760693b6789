"""host_us_per_call.bplg [us]: the mean host time to enqueue one
entry-point call (resolve, plan, launch), by the host clock around the
call with no synchronize."""


def read(record):
    if record.get("driver") != "ops" or not record["enqueue_s"]:
        return None
    return 1e6 * sum(record["enqueue_s"]) / len(record["enqueue_s"])
