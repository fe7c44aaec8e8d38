"""Entries: how a cell hands one input to the program under test
(``chan_vese_tpu_torch``). Each module ``entries/<entry>.py`` has
``prepare(params, cell, device)``, which imports the program, builds once
what every call shares and returns ``call(u0) -> (phi, mask, iters)``, and
``TRAJECTORY``: the trajectory class of the route, which the reference
follows (``cvbench.reference``)."""


def port_params(params):
    """(CVParams, lambda keywords) of the program for the configuration's
    parameters: per-channel weights go to the entry as ``lambda1`` /
    ``lambda2`` tuples, everything else that ``CVParams`` names into it."""
    import dataclasses

    from chan_vese_tpu_torch.params import CVParams

    names = {f.name for f in dataclasses.fields(CVParams)}
    fields, lambdas = {}, {}
    for key, value in params.items():
        if key in ("lambda1", "lambda2") and isinstance(value, list):
            lambdas[key] = tuple(value)
        elif key in names:
            fields[key] = value
    return CVParams(**fields), lambdas
