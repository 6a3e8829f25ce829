"""host.dispatch_ms: host ms a step inside the call into the program
(``slam_step`` returns before the device finishes), mean over the
unprofiled window of a traced run."""


def read(ctx):
    return ctx["dispatch_ms"]
