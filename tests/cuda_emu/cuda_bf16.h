#pragma once
#include "cuda_runtime.h"  // the emulator defines __nv_bfloat16 and its conversions
