"""User extension hook for the default config.

Matches the reference extension point (reference
``slowfast/config/custom_config.py:7``): projects add new keys here so
their YAMLs validate against the merged tree.
"""


def add_custom_config(cfg):
    # Add custom config keys with default values here, e.g.:
    #   cfg.CUSTOM = CfgNode(); cfg.CUSTOM.KEY = value
    return cfg
