"""Share of the prefill rows computed that hold an admitted prompt token
(%): the prompt tokens of the requests each prefill admitted over the
rows it computed, slots x bucket, summed over the window's prefills.
The buckets and their count are the program's ``serve.prefill`` spans;
the prompts are the requests as each prefill admitted them."""


def read(ctx):
    spans = [r for r in ctx.spans if r.name == "serve.prefill"]
    calls = ctx.out["stamps"].prefills
    if not spans or len(spans) != len(calls):
        return None
    rows = int(ctx.cell.settings["slots"])
    computed = sum(rows * int(r.attrs["bucket"]) for r in spans)
    useful = sum(sum(c["plens"]) for c in calls)
    return 100.0 * useful / computed if computed else None
