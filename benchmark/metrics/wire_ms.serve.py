"""Host ms a request in the HTTP handler outside the ``Translator``: the
body read, the npz decode and encode, the dispatch and the response
write, over all requests of the traced window."""


def read(ctx):
    if not ctx.get("requests"):
        return None
    return 1e3 * (ctx.handler_s - ctx.translator_s) / ctx.requests
