"""Problem generators, one module per generator a configuration names.

Each module has ``generate(params: dict, seed: int) -> ProblemArrays``;
``params`` is the configuration file's ``generator_params``. numpy and
scipy only, on the host.
"""
