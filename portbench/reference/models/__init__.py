"""The reference's substitution models, one file a model:
`reference/models/<name>.py`, found by the `model.name` of a
configuration file.  A model file gives

* `ALPHABET`: the states in the order of the rows of its matrices;
* `truth(model) -> (x, freqs)`: its free parameters at the values the
  configuration states, and the frequencies the data are drawn from;
* `start(values, model) -> x`: its free parameters at the values the
  program reported (the program's parameter dict, each a list);
* `values(x, model) -> values`: the inverse of `start`;
* `mixture(x, freqs, model) -> (S, pi, rate, weight)`: float64 tensors,
  differentiable in x: the classes' exchangeabilities [C, ns, ns] and
  frequencies [C, ns], their rates [C] and weights [C];
* optionally `tips(tips, model)`: the observed states' one-hot rows
  [n, P, len(ALPHABET)] mapped onto the model's states.

Each class's Q is S pi scaled to one expected substitution a unit of
time, times its rate (`lnl.system`, `lnl.refine`, `gen.simulate`)."""

from portbench import registry


def of(config: dict):
    return registry.load("reference/models", config["model"]["name"])
