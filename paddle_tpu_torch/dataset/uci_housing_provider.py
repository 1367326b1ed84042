"""Data provider for the paddle_trainer-style CLI configs (reference:
the @provider-decorated dataprovider modules that
define_py_data_sources2 points at; the convention is in
trainer_config_helpers/config.py).  Counterpart of
paddle_tpu/dataset/uci_housing_provider.py."""

from . import uci_housing

__all__ = ["provide"]


def provide(file_list, **kwargs):
    """file_list "train" or "test" selects the split; returns a reader
    yielding (features[13], [price]) rows."""
    return uci_housing.test() if file_list == "test" \
        else uci_housing.train()
