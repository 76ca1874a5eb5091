"""Party runtime: actors + typed messages + the local and pipelined
transports."""
from repro_torch.runtime import messages
from repro_torch.runtime.party import CPState, DataParty, LabelParty, Party
from repro_torch.runtime.scheduler import (TransportDealer, VFLScheduler,
                                           mask_bound_bits,
                                           validate_key_bits)
from repro_torch.runtime.session import TrainState
from repro_torch.runtime.transport import (LocalTransport, LockedRNG,
                                           PipelinedTransport, Transport)

__all__ = [
    "messages", "Party", "DataParty", "LabelParty", "CPState",
    "VFLScheduler", "TransportDealer", "mask_bound_bits",
    "validate_key_bits", "Transport", "LocalTransport",
    "PipelinedTransport", "LockedRNG",
    "TrainState",
]
