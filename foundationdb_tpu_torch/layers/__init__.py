from foundationdb_tpu_torch.layers import tuple as tuple_layer  # noqa: F401
from foundationdb_tpu_torch.layers.subspace import Subspace  # noqa: F401
from foundationdb_tpu_torch.layers.directory import DirectoryLayer  # noqa: F401
