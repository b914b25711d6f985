"""Input rows of every request completed in the window, over the window's
seconds on the host's clock. A request's rows are the rows it scans."""


def read(run):
    done = sum(r.rows for r in run.window.requests if not r.failed)
    return done / run.window.seconds
