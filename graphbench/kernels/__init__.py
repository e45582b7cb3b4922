"""One module a GAP kernel, found by the name a mix gives (manifest.kernel):

    plan(edges, cfg, mix, seed) -> dict         what the trials draw
                                                 from the seed, and what
                                                 the check needs of the
                                                 raw edges besides
                                                 (generators.Edges)
    Trials(g, device, mix, plan)                 .first(), .warm(k) and
                                                 trial i as a call
    check(outputs, ref, cfg, mix, plan) -> dict  numbers, each with its
                                                 limit; failed; info
    control(ref, cfg, mix, plan, outputs)        the reference a step
                                                 below the stated
                                                 precision, in the
                                                 program's place

`outputs` is [(trial index, answer)] in the form Trials returns.
"""
