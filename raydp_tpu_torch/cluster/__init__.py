"""The control plane's transport: the standard-library RPC layer."""
from raydp_tpu_torch.cluster.rpc import (
    RpcClient,
    RpcError,
    RpcServer,
    RpcTimeout,
    RpcUnavailable,
)

__all__ = ["RpcClient", "RpcError", "RpcServer", "RpcTimeout",
           "RpcUnavailable"]
