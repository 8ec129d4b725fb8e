from ice_halo_sim_tpu_torch.config import schema  # noqa: F401
from ice_halo_sim_tpu_torch.config.loader import load_project, load_project_file  # noqa: F401
