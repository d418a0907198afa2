"""The share of the server's fixed batch that carried frames over the
measured window: the frames it served over its batches times the batch
size, from ``InferenceServer.stats()`` read as the window opens and
once its last answer is in.  With the load above what the server
sustains, a full batch says that the socket's readers keep the queue
filled and the drainer sets the pace; a part-filled one, that the
front end does not feed it."""


def read(run):
    c = run.outcome.counters
    if not c.get("batches"):
        return None
    return 100.0 * c["frames"] / (c["batches"] * c["batch_size"])
